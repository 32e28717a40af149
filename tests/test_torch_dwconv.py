"""openeat_torch K3 (depthwise 1-D conv) on the CPU.

The CUDA kernel runs only on a card (chip_smoke.py compares it with the
plain version there). Here: the plain version against the numpy oracle
and the JAX op (its CPU path, _xla_dwconv) within 2e-5; the port's
ConvolutionModule against flax's, causal and not, within 1e-5; and the
wrapper's CPU route, which never touches the launch counter or nvcc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.modules.convolution import \
    ConvolutionModule as FlaxConvolutionModule
from openeat_tpu.ops.depthwise_conv import (depthwise_conv1d_ref,
                                            depthwise_conv1d as jax_dwconv)
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.modules.convolution import ConvolutionModule
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import nvcc
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import _draw

torch.set_num_threads(1)
SHAPES = [(2, 19, 8, 15), (3, 40, 16, 7), (1, 15, 4, 15), (8, 124, 256, 15)]


def _xw(b, t, c, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t + k - 1, c)).astype(np.float32)
    w = (rng.standard_normal((k, c)) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("b,t,c,k", SHAPES)
def test_plain_matches_oracle_and_jax(b, t, c, k):
    x, w = _xw(b, t, c, k)
    out = dw.depthwise_conv1d_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (b, t, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), depthwise_conv1d_ref(x, w),
                               rtol=2e-5, atol=2e-5)
    jax_out = np.asarray(jax_dwconv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(out.numpy(), jax_out, rtol=2e-5, atol=2e-5)


def test_plain_bf16_is_the_f32_sum_rounded_once():
    x, w = _xw(2, 30, 64, 15, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    out = dw.depthwise_conv1d_plain(xb, wb)
    assert out.dtype == torch.bfloat16
    ref = dw.depthwise_conv1d_plain(xb.float(), wb.float()).bfloat16()
    assert torch.equal(out, ref)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(nvcc, "load_library", no_build)
    monkeypatch.setattr(nvcc, "build_library", no_build)
    before = dw.depthwise_conv1d.launches
    x, w = _xw(2, 19, 8, 15)
    out = dw.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    assert dw.depthwise_conv1d.launches == before
    np.testing.assert_array_equal(
        out.numpy(), dw.depthwise_conv1d_plain(torch.from_numpy(x),
                                               torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("x_shape,w_shape,dtype,err", [
    ((2, 10, 8), (15, 8), torch.float32, ValueError),   # T+K-1 < K
    ((2, 20, 8), (15, 4), torch.float32, ValueError),   # C mismatch
    ((2, 20, 8), (15, 8), torch.float16, TypeError),    # dtype
])
def test_wrapper_rejects_what_the_kernel_does_not_take(x_shape, w_shape,
                                                       dtype, err):
    with pytest.raises(err):
        dw.depthwise_conv1d(torch.zeros(x_shape, dtype=dtype),
                            torch.zeros(w_shape, dtype=dtype))
    with pytest.raises(ValueError, match="contiguous"):
        dw.depthwise_conv1d(torch.zeros(2, 8, 20).transpose(1, 2),
                            torch.zeros(15, 8))


@pytest.mark.parametrize("causal", [False, True])
def test_convolution_module_matches_flax(causal):
    b, t, c, k = 3, 23, 16, 15
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lens = np.array([23, 17, 9])
    mask = (np.arange(t)[None, :] < lens[:, None])[:, None, :]
    fm = FlaxConvolutionModule(c, k, causal=causal)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    tm = ConvolutionModule(c, k, causal=causal)
    tm.load_state_dict(flax_to_state_dict(_flatten(variables), tm))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
