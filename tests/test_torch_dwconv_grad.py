"""openeat_torch K3 backward on the CPU: dgrad and wgrad through the
autograd Function's CPU route (the plain versions of the formulas the
CUDA kernels run) against jax.grad of
openeat_tpu.ops.depthwise_conv.depthwise_conv1d (its custom VJP on the
CPU XLA path), within 2e-5 (float32; the gap is summation order).

The CUDA dgrad and wgrad kernels run only on a card; chip_smoke.py holds
them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.ops.depthwise_conv import depthwise_conv1d as jax_dwconv
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import nvcc

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(b, t, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t + k - 1, c)).astype(np.float32)
    w = (rng.standard_normal((k, c)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, t, c)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("b,t,c,k", [(2, 19, 8, 15), (3, 40, 16, 7),
                                     (1, 1, 4, 15), (5, 33, 24, 7),
                                     # K = 31 (runtime-K kernel); C = 70
                                     # and 136 are not multiples of the
                                     # 64-channel float32 tile
                                     (2, 24, 70, 31), (3, 9, 136, 15)])
def test_grads_match_jax(b, t, c, k):
    x, w, dy = _case(b, t, c, k, seed=b * 100 + t)

    def f(xx, ww):
        return jnp.sum(jax_dwconv(xx, ww) * jnp.asarray(dy))

    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (dw.depthwise_conv1d(xt, wt) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


def test_backward_is_the_plain_formulas():
    """The Function's CPU backward is exactly the plain dgrad (forward on
    padded dy with reversed taps) and the float32 wgrad sum."""
    x, w, dy = _case(2, 21, 8, 15, seed=7)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dyt = torch.from_numpy(dy)
    dw.depthwise_conv1d(xt, wt).backward(dyt)
    assert torch.equal(xt.grad, dw.depthwise_conv1d_dgrad_plain(
        dyt, torch.from_numpy(w)))
    assert torch.equal(wt.grad, dw.depthwise_conv1d_wgrad_plain(
        torch.from_numpy(x), dyt))


def test_bf16_grads_follow_the_jax_dtype_rules():
    """dx comes back in x's dtype and dw in w's, the wgrad summed in
    float32 and rounded once."""
    x, w, dy = _case(2, 30, 16, 15, seed=3)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    wb = torch.from_numpy(w).bfloat16().requires_grad_()
    dyb = torch.from_numpy(dy).bfloat16()
    dw.depthwise_conv1d(xb, wb).backward(dyb)
    assert xb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.bfloat16
    ref = dw.depthwise_conv1d_wgrad_plain(xb.detach().float(), dyb.float())
    assert torch.equal(wb.grad, ref.bfloat16())


def test_cpu_backward_never_reaches_a_kernel(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(nvcc, "load_library", no_build)
    monkeypatch.setattr(nvcc, "build_library", no_build)
    before = (dw.depthwise_conv1d.launches, dw.depthwise_conv1d_dgrad.launches,
              dw.depthwise_conv1d_wgrad.launches)
    x, w, dy = _case(2, 19, 8, 15, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dw.depthwise_conv1d(xt, wt).backward(torch.from_numpy(dy))
    assert (dw.depthwise_conv1d.launches, dw.depthwise_conv1d_dgrad.launches,
            dw.depthwise_conv1d_wgrad.launches) == before


def test_dgrad_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_dgrad(torch.zeros(2, 6, 8), torch.zeros(15, 4))
    with pytest.raises(TypeError):
        dw.depthwise_conv1d_dgrad(torch.zeros(2, 6, 8, dtype=torch.float16),
                                  torch.zeros(15, 8))
    with pytest.raises(ValueError, match="contiguous"):
        dw.depthwise_conv1d_dgrad(torch.zeros(2, 8, 6).transpose(1, 2),
                                  torch.zeros(15, 8))


def test_dgrad_casts_w_to_dy_dtype():
    x, w, dy = _case(2, 12, 8, 7, seed=5)
    dyb = torch.from_numpy(dy).bfloat16()
    out = dw.depthwise_conv1d_dgrad(dyb, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 18, 8)
    assert torch.equal(out, dw.depthwise_conv1d_dgrad_plain(
        dyb, torch.from_numpy(w).bfloat16()))


def test_wgrad_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_wgrad(torch.zeros(2, 20, 8), torch.zeros(2, 6, 4))
    with pytest.raises(TypeError):
        dw.depthwise_conv1d_wgrad(torch.zeros(2, 20, 8),
                                  torch.zeros(2, 6, 8, dtype=torch.float64))
