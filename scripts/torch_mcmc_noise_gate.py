"""The MCMC position noise under three opacity gates, on the CPU.

    python3 scripts/torch_mcmc_noise_gate.py [--steps 150]

Fits the small COLMAP scene of tests/test_torch_fit_e2e.py (6 views of 200
Gaussians rendered by the port at 64x64) with `colmap.yaml` + `mcmc.yaml`
through `gsl_tpu_torch.cli` three times, the noise gated by

- the port's gate, sigmoid(100 ((1 - op) - 0.995)), the published 3DGS-MCMC
  code's `op_sigmoid(1 - opacity)`;
- gsl_tpu's gate, sigmoid(-100 (op - 0.995)) (gsl_tpu/training/mcmc.py);
- no noise at all,

and prints each run's val PSNR and the largest |coordinate| of its alive
means. Everything but the gate is the port's `mcmc_noise_step`.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from gsl_tpu_torch import cli  # noqa: E402
from gsl_tpu_torch.ops.transforms import build_cov3d, normalize_quat  # noqa
from gsl_tpu_torch.training import hooks  # noqa: E402
from test_torch_fit_e2e import make_colmap_dataset  # noqa: E402

GATES = {
    "port": lambda op: torch.sigmoid(100.0 * ((1.0 - op) - 0.995)),
    "gsl_tpu": lambda op: torch.sigmoid(-100.0 * (op - 0.995)),
    "none": lambda op: torch.zeros_like(op),
}


def noise_step(gate):
    """mcmc_noise_step with another gate."""
    def step(sample, gstate, means_lr, noise_lr=5e5):
        p = gstate.params
        g = gate(torch.sigmoid(p.opacities[:, 0]))
        eps = torch.randn(p.means.shape, generator=sample,
                          dtype=p.means.dtype, device=p.means.device)
        cov = build_cov3d(torch.exp(p.scales), normalize_quat(p.rotations))
        noise = (cov * eps[:, None, :]).sum(-1) \
            * (g * noise_lr * means_lr)[:, None]
        noise = torch.where(gstate.alive[:, None], noise,
                            torch.zeros_like(noise))
        return dataclasses.replace(gstate, params=dataclasses.replace(
            p, means=p.means + noise))
    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "scene")
        make_colmap_dataset(root)
        configs = [os.path.join(REPO, "gsl_tpu_torch", "configs", p)
                   for p in ("colmap.yaml", "mcmc.yaml")]
        for name, gate in GATES.items():
            hooks.mcmc_noise_step = noise_step(gate)
            state, results = cli.main([
                "fit", "--config", configs[0], "--config", configs[1],
                "--data.path", root, "--output", tmp, "-n", name,
                "--max_steps", str(args.steps), "--device", "cpu",
                "fit.min_capacity=1024", "fit.log_interval=50",
                "model.gaussian.sh_degree=0",
                "model.density.init_args.densify_from_iter=50",
                "model.density.init_args.densification_interval=50"])
            reach = float(state.params.means[state.alive].abs().max())
            print(f"gate {name}: val PSNR {results['psnr']:.3f} dB after "
                  f"{args.steps} steps, alive means out to |x| = "
                  f"{reach:.1f}", flush=True)


if __name__ == "__main__":
    main()
