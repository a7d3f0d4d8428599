// The ray-splat solve of one (pixel, surfel) pair, shared by the surfel
// forward (K6) and backward (K7) kernels so that both take the same
// decisions from the same rounded values.
//
// Mirrors gsl_tpu/ops/surfel_pallas.py::_surfel_terms. A surfel is given by
// the homogeneous pixel-space rows Tu, Tv, Tw of its local frame, the depth
// coefficients zc = (zu, zv, z0) and its opacity. With
//   hx_i = px * T_i[2] - T_i[0],  hy_i = py * T_i[2] - T_i[1]   (i = u, v, w)
// the intersection of the pixel's ray with the surfel's plane is
// (u, v, 1) ~ hx x hy. rho3d = u^2 + v^2 is the Gaussian's argument there,
// rho2d = 2 |pixel - projected centre|^2 the screen-space low-pass, and the
// smaller of the two is used. Where the low-pass wins, the depth is the
// centre's: a near-degenerate solve (|sz| ~ 1e-12) puts u, v near 1e24 while
// the filter keeps alpha alive, and the plane depth would be meaningless.
#pragma once

namespace surfel {

constexpr int kGeom = 13;   // Tu(3) Tv(3) Tw(3) zc(3) opacity(1)
constexpr int kSplat = 15;  // kGeom + projected centre (cxp, cyp)

struct Terms {
  float hx[3], hy[3];  // u, v, w
  float cz, u, v, dxp, dyp, depth, G, raw, alpha;
  bool use3d, keep;
};

// Per-splat values derived once when a batch is loaded: the projected
// centre Tw.xy / Tw.z with a zero Tw.z replaced by 1.
__device__ __forceinline__ float safe_twz(float twz) {
  return twz == 0.0f ? 1.0f : twz;
}

// g: the splat's kSplat values, element k at g[k * stride].
__device__ __forceinline__ Terms solve(const float* g, int stride, float px,
                                       float py) {
  Terms t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float tx = g[(3 * i + 0) * stride];
    const float ty = g[(3 * i + 1) * stride];
    const float tw = g[(3 * i + 2) * stride];
    t.hx[i] = px * tw - tx;
    t.hy[i] = py * tw - ty;
  }
  const float sx = t.hx[1] * t.hy[2] - t.hx[2] * t.hy[1];
  const float sy = t.hx[2] * t.hy[0] - t.hx[0] * t.hy[2];
  const float sz = t.hx[0] * t.hy[1] - t.hx[1] * t.hy[0];
  const bool sz_ok = fabsf(sz) >= static_cast<float>(1e-12);
  t.cz = sz_ok ? sz : 1.0f;
  t.u = sx / t.cz;
  t.v = sy / t.cz;
  const float rho3d = t.u * t.u + t.v * t.v;
  t.dxp = px - g[13 * stride];
  t.dyp = py - g[14 * stride];
  const float rho2d = 2.0f * (t.dxp * t.dxp + t.dyp * t.dyp);
  t.use3d = rho3d <= rho2d;
  const float rho = t.use3d ? rho3d : rho2d;
  const float z0 = g[11 * stride];
  t.depth = t.use3d ? z0 + t.u * g[9 * stride] + t.v * g[10 * stride] : z0;
  t.G = expf(-0.5f * rho);
  t.raw = g[12 * stride] * t.G;
  t.alpha = fminf(static_cast<float>(0.99), t.raw);
  t.keep = t.alpha >= static_cast<float>(1.0 / 255.0) && sz_ok &&
           t.depth >= static_cast<float>(0.2);
  return t;
}

// NDC-like depth of the distortion loss, near 0.2 / far 100.
__device__ __forceinline__ float map_depth(float d) {
  return (100.0f * (d - static_cast<float>(0.2))) /
         (static_cast<float>(100.0 - 0.2) * fmaxf(d, static_cast<float>(1e-6)));
}

__device__ __forceinline__ float dmap_ddepth(float d) {
  const float dc = fmaxf(d, static_cast<float>(1e-6));
  const float dm = static_cast<float>(100.0 * 0.2) /
                   (static_cast<float>(100.0 - 0.2) * (dc * dc));
  return d > static_cast<float>(1e-6) ? dm : 0.0f;
}

}  // namespace surfel
