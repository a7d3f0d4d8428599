"""gsl_tpu_torch's visualizers (tensors in, tensors out, on the input's
device) against gsl_tpu's numpy ones on the same arrays, and ViewerRenderer's
single uint8 copy to the host."""
import numpy as np
import pytest
import torch

from gsl_tpu.utils import visualizers as jv

from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.utils import visualizers as tv
from gsl_tpu_torch.viewer import renderer as viewer_module

from torch_port_utils import small_port_state, to_torch


def _depth(seed, kind):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.0, 7.0, (24, 32)).astype(np.float32)
    if kind == "holes":
        d[rng.rand(24, 32) < 0.2] = 0.0
        d[3, 4], d[5, 6], d[7, 8] = np.inf, -np.inf, np.nan
        d[9, 10] = -2.0
    elif kind == "nothing_finite":
        d[:] = np.nan
        d[::2] = np.inf
    elif kind == "nothing_positive":
        d = -d
    return d


@pytest.mark.parametrize("kind", ["plain", "holes", "nothing_finite",
                                  "nothing_positive"])
def test_gray_output_matches_numpy(kind):
    """1e-6: the same float32 polynomial; the scale is the largest finite
    positive depth, or 1 when there is none. NaN pixels stay NaN on both
    sides."""
    d = _depth(1, kind)
    want = jv.visualize_output("gray", d)
    got = tv.visualize_output("gray", to_torch(d))
    assert isinstance(got, torch.Tensor) and got.shape == (24, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                               equal_nan=True)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    fixed = tv.visualize_depth(to_torch(d), max_depth=5.0).numpy()
    np.testing.assert_allclose(fixed, jv.visualize_depth(d, max_depth=5.0),
                               rtol=0, atol=1e-6, equal_nan=True)


def test_normal_map_and_rgb_match_numpy():
    rng = np.random.RandomState(2)
    normal = rng.uniform(-1.2, 1.2, (24, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tv.visualize_output("normal_map", to_torch(normal)).numpy(),
        jv.visualize_output("normal_map", normal), rtol=0, atol=1e-6)
    rgb = rng.uniform(-0.2, 1.2, (24, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tv.visualize_output("rgb", to_torch(rgb)).numpy(),
        jv.visualize_output("rgb", rgb), rtol=0, atol=1e-6)
    x = np.linspace(-0.1, 1.1, 50, dtype=np.float32).reshape(5, 10)
    np.testing.assert_allclose(tv.turbo_colormap(to_torch(x)).numpy(),
                               jv.turbo_colormap(x), rtol=0, atol=1e-6)


def test_visualizers_stay_on_the_inputs_device_and_dtype():
    """No numpy on the way: the result is a tensor made from the input by
    tensor operations only (a meta tensor has no data to copy out)."""
    for key_type, shape in (("gray", (8, 8)), ("normal_map", (8, 8, 3)),
                            ("rgb", (8, 8, 3))):
        out = tv.visualize_output(key_type, torch.empty(shape, device="meta"))
        assert out.device.type == "meta" and out.shape == (8, 8, 3)
        assert out.dtype == torch.float32


@pytest.mark.parametrize("output_type", ["rgb", "alpha", "exp_depth",
                                         "inverse_depth", "normal"])
def test_viewer_renderer_copies_one_uint8_image_to_the_host(monkeypatch,
                                                            output_type):
    """ViewerRenderer.get_outputs moves exactly one tensor to the host,
    the quantized uint8 frame, for every output type."""
    RW, RH = 64, 48
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append((self.dtype, tuple(self.shape)))
        return real_cpu(self, *a, **kw)

    viewer = viewer_module.ViewerRenderer(
        small_port_state(), TileRendererConfig().instantiate(), 3)
    viewer.output_type = output_type
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "numpy", _no_float_numpy(
        torch.Tensor.numpy))
    frame = viewer.get_outputs(np.eye(4), RW, RH)
    assert copies == [(torch.uint8, (RH, RW, 3))]
    assert frame.dtype == np.uint8 and int(frame.max()) > 50


def _no_float_numpy(real_numpy):
    def numpy(self, *a, **kw):
        assert self.dtype == torch.uint8, "a float image went to numpy"
        return real_numpy(self, *a, **kw)
    return numpy
