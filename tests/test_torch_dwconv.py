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


# ------------------------------------------------------------ launch plan
#
# The CUDA kernel runs only on the card; these hold the launch decision it
# is given (dw.launch_plan) to the kernel's limits, and a numpy walk of
# the plan's blocks, items and threads to the plain versions.

def _plan(b, t_in, c, k, itemsize, dgrad=False, x_ptr=0, **device):
    return dw.launch_plan(b, t_in, c, k, itemsize, dgrad=dgrad, x_ptr=x_ptr,
                          **device)


def _within_kernel_limits(p, itemsize, blocks=2 * 132):
    assert p.smem_bytes <= 227 * 1024
    assert p.block == (p.c_tile // dw.VEC, dw.T_TILE // dw.RT)
    assert p.block[0] * p.block[1] <= 256
    assert dw.VEC * itemsize in (8, 16) and p.c_tile % dw.VEC == 0
    assert (p.c_tile * itemsize) % 16 == 0
    assert p.rows <= 256 and p.c_tile <= 256
    assert 1 <= p.grid[1] <= min(p.n_items, 65535) and p.grid[0] >= 1
    # at most `blocks` (two per SM), rounded up to whole channel tiles
    assert p.grid[1] * p.grid[0] < blocks + p.grid[0]
    if p.route == "tma":
        assert p.copy_bytes == 0
        assert p.tma_box == (p.c_tile, p.rows, 1)
        assert (p.tma_box[0] * itemsize) % 16 == 0
    else:
        assert p.copy_bytes in (4, 8, 16) and p.tma_box is None


@pytest.mark.parametrize("k", [1, 7, 15, 31, 64])
@pytest.mark.parametrize("c,itemsize,route,copy_bytes", [
    (256, 4, "tma", 0), (256, 2, "tma", 0), (100, 2, "cp.async", 8),
    (4, 4, "tma", 0), (4, 2, "cp.async", 8), (70, 4, "cp.async", 8),
    (6, 2, "cp.async", 4)])
@pytest.mark.parametrize("dgrad", [False, True])
def test_launch_plan_routes_and_limits(k, c, itemsize, route, copy_bytes,
                                       dgrad):
    t = 212
    p = _plan(8, t, c, k, itemsize, dgrad)
    assert (p.route, p.copy_bytes) == (route, copy_bytes)
    assert p.pad_left == (k - 1 if dgrad else 0)
    assert p.t_out == (t + k - 1 if dgrad else t - k + 1)
    assert p.rows == dw.T_TILE + k - 1
    assert p.taps_in_registers == (k == 15)
    _within_kernel_limits(p, itemsize)


def test_launch_plan_at_the_main_path_shapes():
    """[8, 212, 256] f32 forward: 4 channel tiles x 56 items, one item per
    block; [22, 162, 256] f32 dgrad: 528 tiles on 2 x 132 blocks, two
    items each, both in flight through the two-stage ring."""
    p = _plan(8, 212, 256, 15, 4)
    assert (p.route, p.grid, p.block, p.t_out) == ("tma", (4, 56), (16, 8),
                                                   198)
    assert p.smem_bytes == 128 + 2 * 46 * 256 + 16
    p = _plan(22, 162, 256, 15, 4, dgrad=True)
    assert (p.grid, p.n_items, p.t_out) == ((4, 66), 132, 176)
    p = _plan(22, 162, 256, 15, 2, dgrad=True)
    assert (p.route, p.c_tile, p.grid, p.block) == ("tma", 64, (4, 66),
                                                    (16, 8))
    assert p.smem_bytes == 128 + 2 * 46 * 128 + 16


def test_launch_plan_grid_limits_at_large_batch_and_length():
    for dgrad in (False, True):
        for itemsize in (2, 4):
            p = _plan(256, 2000, 256, 15, itemsize, dgrad)
            assert p.n_items == 256 * -(-p.t_out // 32)
            assert p.grid[1] <= 65535 and p.grid[0] * p.grid[1] <= 264
            _within_kernel_limits(p, itemsize)


def test_launch_plan_route_follows_the_input_address():
    assert _plan(2, 40, 256, 15, 4, x_ptr=4).route == "cp.async"
    assert _plan(2, 40, 256, 15, 4, x_ptr=4).copy_bytes == 4
    assert _plan(2, 40, 256, 15, 2, x_ptr=8).copy_bytes == 8
    assert _plan(2, 40, 256, 15, 2, x_ptr=32).route == "tma"


@pytest.mark.parametrize("args,match", [
    ((2, 40, 5, 7, 2), "multiples of 4 bytes"),       # odd C in bf16
    ((2, 40, 256, 7, 2, False, 2), "multiples of 4"),  # 2-byte offset
    ((2, 40, 8, 65, 4), "K <= 64"),
    ((2, 10, 8, 15, 4), "empty"),                     # forward T_out < 1
    ((2, 40, 8, 7, 8), "2- or 4-byte"),
])
def test_launch_plan_refuses_what_no_route_takes(args, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args)


def test_kernel_source_and_plan_share_their_constants():
    """The kernel's launcher derives its tiles from these constants and
    the Python plan states the same tiles; both must use the same
    values."""
    src = (nvcc.CSRC_DIR / dw.SOURCE).read_text()
    for name in ("VEC", "RT", "C_TILE", "T_TILE", "STAGES", "BLOCKS_PER_SM",
                 "K_FIXED", "SMEM_MAX", "MAX_BOX"):
        assert f"constexpr int {name} = {getattr(dw, name)};" in src, name
    assert dw.C_TILE <= dw.MAX_BOX


def _walk(plan, xin, w, dgrad, itemsize):
    """numpy run of the kernel as planned: every block, every item it
    walks, each item's zero-filled input window as the TMA box or the
    cp.async copies build it, each thread's RT x VEC outputs. Returns
    the float32 output and how many times each element was written."""
    b_, t_in, c = xin.shape
    k = w.shape[0]
    taps = w[::-1] if dgrad else w
    out = np.full((b_, plan.t_out, c), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int64)
    for bx in range(plan.grid[0]):
        c0 = bx * plan.c_tile
        for by in range(plan.grid[1]):
            for item in range(by, plan.n_items, plan.grid[1]):
                b, tt = divmod(item, plan.t_tiles)
                t0 = tt * dw.T_TILE
                lo = t0 - plan.pad_left
                win = np.full((plan.rows, plan.c_tile), np.nan, np.float32)
                if plan.route == "tma":
                    box = np.zeros(plan.tma_box[1::-1], np.float32)
                    for r in range(plan.rows):
                        if 0 <= lo + r < t_in:
                            ch = np.arange(c0, min(c0 + plan.c_tile, c))
                            box[r, ch - c0] = xin[b, lo + r, ch]
                    win[:] = box
                else:
                    e = plan.copy_bytes // itemsize
                    for r in range(plan.rows):
                        for q in range(plan.c_tile // e):
                            cc = c0 + q * e
                            if cc >= c:
                                continue
                            win[r, cc - c0:cc - c0 + e] = (
                                xin[b, lo + r, cc:cc + e]
                                if 0 <= lo + r < t_in else 0.0)
                tp = np.zeros((k, plan.c_tile), np.float32)
                tp[:, :min(plan.c_tile, c - c0)] = taps[:, c0:c0 + plan.c_tile]
                acc = win[0:dw.T_TILE] * tp[0]
                for j in range(1, k):
                    acc = acc + win[j:j + dw.T_TILE] * tp[j]
                for ty in range(plan.block[1]):
                    for tx in range(plan.block[0]):
                        r0, cl = ty * dw.RT, tx * dw.VEC
                        t_hi = min(t0 + r0 + dw.RT, plan.t_out)
                        c_hi = min(c0 + cl + dw.VEC, c)
                        if t0 + r0 >= t_hi or c0 + cl >= c_hi:
                            continue
                        out[b, t0 + r0:t_hi, c0 + cl:c_hi] = acc[
                            r0:r0 + t_hi - t0 - r0, cl:cl + c_hi - c0 - cl]
                        writes[b, t0 + r0:t_hi, c0 + cl:c_hi] += 1
    return out, writes


@pytest.mark.parametrize("b,t_in,c,k,dtype,dgrad,device", [
    (3, 40, 100, 7, torch.float32, False, {}),    # ragged C tile, TMA
    (3, 40, 100, 7, torch.bfloat16, False, {}),   # cp.async, 8 B copies
    (2, 75, 136, 15, torch.float32, False, {}),   # TMA, C not a tile multiple
    (2, 75, 136, 15, torch.bfloat16, False, {}),
    (3, 34, 100, 7, torch.float32, True, {}),
    (3, 34, 100, 7, torch.bfloat16, True, {}),
    (1, 1, 4, 15, torch.float32, True, {}),       # dgrad with T < K
    (1, 1, 4, 15, torch.bfloat16, True, {}),
    (2, 5, 12, 31, torch.float32, True, {}),      # runtime K, T < K
    (2, 70, 64, 1, torch.float32, False, {}),
    # cards with few SMs: blocks walk several items through the ring
    (4, 50, 72, 15, torch.float32, True, {"num_sms": 3}),
    (2, 75, 136, 15, torch.bfloat16, True, {"num_sms": 2}),
    (3, 90, 256, 15, torch.bfloat16, False, {"num_sms": 1}),
    # other routes: 4-byte copies of an unaligned input, K = 64
    (2, 40, 6, 5, torch.bfloat16, True, {}),
    (2, 40, 20, 7, torch.float32, False, {"x_ptr": 4}),
    (2, 20, 16, 64, torch.float32, True, {}),
])
def test_plan_walk_is_the_plain_version_bit_for_bit(b, t_in, c, k, dtype,
                                                    dgrad, device):
    rng = np.random.default_rng(t_in * 1000 + c + k)
    xin = torch.from_numpy(rng.standard_normal((b, t_in, c)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, c)) * 0.3).astype(
        np.float32)).to(dtype)
    itemsize = xin.element_size()
    plan = _plan(b, t_in, c, k, itemsize, dgrad, **device)
    _within_kernel_limits(plan, itemsize,
                          dw.BLOCKS_PER_SM * device.get("num_sms", 132))
    out, writes = _walk(plan, xin.float().numpy(), w.float().numpy(), dgrad,
                        itemsize)
    assert (writes == 1).all()
    got = torch.from_numpy(out).to(dtype)
    ref = (dw.depthwise_conv1d_dgrad_plain(xin, w) if dgrad
           else dw.depthwise_conv1d_plain(xin, w))
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


def test_ptxas_report_parses_each_entry():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    assert nvcc.ptxas_entries(log) == [
        {"entry": "_Z3fooPf", "registers": 168, "spill_stores": 0,
         "spill_loads": 0},
        {"entry": "_Z3barv", "registers": 255, "spill_stores": 4,
         "spill_loads": 12}]
