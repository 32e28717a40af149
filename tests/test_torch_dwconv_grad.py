"""openeat_torch K3 backward on the CPU: dgrad and wgrad through the
autograd Function's CPU route (the plain versions of the formulas the
CUDA kernels run) against jax.grad of
openeat_tpu.ops.depthwise_conv.depthwise_conv1d (its custom VJP on the
CPU XLA path), within 2e-5 (float32; the gap is summation order).

The CUDA dgrad and wgrad kernels run only on a card; chip_smoke.py holds
them against these plain versions there.
"""

import re

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
                                     # K = 31 (the kernels' compile-time
                                     # instances on the card); C = 70 and
                                     # 136 are not multiples of the
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


# ------------------------------------------------------------ wgrad plan
#
# The wgrad kernel runs only on the card; these hold its launch decision
# (dw.wgrad_plan) to the kernel's limits and walk the plan in numpy: every
# block, item, row group and pass, summed in the planned order.

def test_wgrad_kernel_source_and_plan_share_their_constants():
    src = (nvcc.CSRC_DIR / dw.SOURCE).read_text()
    for name in ("W_C_TILE", "W_ROWS", "W_GROUPS", "W_KC", "W_TAP_GROUPS",
                 "W_STAGES", "W_BLOCKS_PER_SM", "W_MAX_CTILES", "K_FIXED",
                 "K_WIDE", "SMEM_MAX", "MAX_BOX", "VEC"):
        assert f"constexpr int {name} = {getattr(dw, name)};" in src, name


def _tap_sets(plan, k):
    """The taps a thread sums at once, in the kernel's order: one pass
    (a compile-time K) gives tap group z the taps [z * kc, (z + 1) * kc)
    below K (the last group's slots past K are products of clamped rows
    that the kernel drops); the run-time route's passes take kc taps
    each."""
    if plan.one_pass:
        return [np.arange(z * plan.kc, min((z + 1) * plan.kc, k))
                for z in range(plan.tap_groups)]
    return [np.arange(j0, min(j0 + plan.kc, k))
            for j0 in range(0, k, plan.kc)]


def _wgrad_walk(plan, x, dy):
    """numpy run of the wgrad kernel as planned, in float32 and in its
    order of sums: each thread's rows in order (one pass: each tap group's
    sums over all of its block's items; otherwise each item's passes
    added into its slots), the row groups in order, the splits in order.
    Returns dw and how many times each product x[b, t+j, c] * dy[b, t, c]
    was added."""
    b_, t_in, c = x.shape
    k = t_in - plan.t_out + 1
    groups = plan.block[1]
    taps = _tap_sets(plan, k)
    counts = np.zeros((b_, plan.t_out, k, c), np.uint8)
    dw_ = np.full((k, c), np.nan, np.float32)
    for ct in range(plan.n_ctiles):
        c0 = ct * plan.c_tile
        ch = np.arange(c0, min(c0 + plan.c_tile, c))
        total = None
        for split in range(plan.splits):
            red = np.zeros((groups, k, ch.size), np.float32)
            items = range(split * plan.per,
                          min((split + 1) * plan.per, plan.n_items))
            assert len(items) >= 1
            for item in items:
                b, qi = divmod(item, plan.q)
                t0 = qi * plan.rows
                n_rows = min(plan.rows, plan.t_out - t0)
                for g in range(groups):
                    lo = g * n_rows // groups
                    hi = (g + 1) * n_rows // groups
                    for js in taps:
                        acc = red[g, js] if plan.one_pass else \
                            np.zeros((js.size, ch.size), np.float32)
                        for r in range(lo, hi):
                            t = t0 + r
                            # window row r + j, inside the staged window
                            assert r + js[-1] < plan.x_rows
                            acc = acc + x[b, t + js][:, ch] * dy[b, t, ch]
                            counts[b, t, js[:, None], ch[None, :]] += 1
                        red[g, js] = acc if plan.one_pass else \
                            red[g, js] + acc
            part = red[0]
            for g in range(1, groups):
                part = part + red[g]
            total = part if total is None else total + part
        dw_[:, ch] = total
    return dw_, counts


@pytest.mark.parametrize("b,t_in,c,k,itemsize,device", [
    (2, 40, 100, 7, 4, {}),                  # C not a multiple of the tile
    (3, 30, 70, 15, 4, {"num_sms": 3}),      # K_FIXED, several items a block
    (1, 60, 40, 31, 2, {"num_sms": 2}),      # K_WIDE, several items a block
    (1, 60, 40, 23, 2, {"num_sms": 2}),      # three passes of W_KC taps
    (2, 16, 8, 15, 4, {}),                   # small B*T: one row a block
    (4, 150, 36, 7, 2, {"num_sms": 5}),      # chunks of W_ROWS, ragged
    (1, 300, 8, 64, 4, {}),                  # K = 64: shorter items
    (1, 20, 12, 15, 2, {"x_ptr": 2}),        # the element route
    # K_WIDE on every route: TMA, cp.async of 8 and 4 bytes, element
    # loads (odd C, a 2-byte offset), few SMs, T = K, long T, wide C
    (2, 80, 256, 31, 4, {}),
    (3, 60, 100, 31, 2, {}),
    (2, 45, 6, 31, 2, {}),
    (3, 60, 99, 31, 2, {}),
    (2, 50, 40, 31, 2, {"dy_ptr": 2}),
    (3, 70, 36, 31, 4, {"num_sms": 1}),
    (1, 31, 4, 31, 4, {}),
    (1, 420, 8, 31, 2, {"num_sms": 3}),
    # the LibriSpeech Conformer's micro-batches
    (4, 353, 256, 31, 2, {}),
    (3, 428, 256, 31, 2, {}),
    (2, 453, 256, 31, 4, {}),
])
def test_wgrad_plan_walk_counts_each_product_once(b, t_in, c, k, itemsize,
                                                  device):
    plan = dw.wgrad_plan(b, t_in, c, k, itemsize, **device)
    t_out = t_in - k + 1
    assert plan.cluster == (k == dw.K_WIDE)
    assert plan.t_out == t_out
    assert plan.rows <= (dw.W_WIDE_ROWS if plan.cluster else dw.W_ROWS)
    # no shorter items than shared memory needs
    assert plan.rows == -(-t_out // plan.q)
    assert plan.q * plan.rows >= t_out > (plan.q - 1) * plan.rows
    assert plan.n_items == b * plan.q
    assert plan.per * plan.splits >= plan.n_items \
        > plan.per * (plan.splits - 1)
    assert plan.grid == (plan.n_ctiles, plan.splits)
    assert plan.block == (plan.c_tile // dw.VEC, dw.W_WIDE_GROUPS
                          if plan.cluster else dw.W_GROUPS, plan.tap_groups)
    # a cluster is at most W_CLUSTER blocks, and every block has items
    assert not plan.cluster or plan.splits <= dw.W_CLUSTER
    # one pass: every tap in exactly one group, none empty, and at most
    # 16 x VEC sums a thread beside a window as large
    if plan.one_pass:
        assert plan.kc * plan.tap_groups >= k \
            > plan.kc * (plan.tap_groups - 1)
        assert plan.kc <= 16
    assert plan.x_rows == plan.rows + k - 1 <= dw.MAX_BOX
    assert plan.smem_bytes <= dw.SMEM_MAX
    assert plan.ws_floats == dw.W_MAX_CTILES + (
        0 if plan.cluster else plan.n_ctiles * plan.splits * k * plan.c_tile)
    rng = np.random.default_rng(t_in * 100 + c + k)
    x = rng.standard_normal((b, t_in, c)).astype(np.float32)
    dy = rng.standard_normal((b, t_out, c)).astype(np.float32)
    got, counts = _wgrad_walk(plan, x, dy)
    assert (counts == 1).all()
    ref = dw.depthwise_conv1d_wgrad_plain(torch.from_numpy(x),
                                          torch.from_numpy(dy)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_wgrad_plan_at_the_main_path_shape():
    """[22, 162, 256] K=15: 8 tiles of 32 channels x 15 blocks of 3
    items (74 rows each) by TMA; a bfloat16 dy at an 8-byte offset takes
    cp.async, a float32 x off a 4-byte boundary is refused; K = 64 over
    a long T takes shorter items to fit shared memory."""
    p = dw.wgrad_plan(22, 162, 256, 15, 4)
    assert (p.route, p.c_tile, p.grid, p.per, p.rows, p.q) == (
        "tma", 32, (8, 15), 3, 74, 2)
    assert p.block == (8, 16, 1) and p.kc == 15 and p.one_pass
    p2 = dw.wgrad_plan(22, 162, 256, 15, 2, x_ptr=0, dy_ptr=8)
    assert (p2.route, p2.copy_bytes) == ("cp.async", 8)
    with pytest.raises(ValueError):
        dw.wgrad_plan(2, 40, 8, 7, 4, x_ptr=2)
    p = dw.wgrad_plan(2, 400, 256, 64, 4)
    assert p.rows < dw.W_ROWS and p.smem_bytes <= dw.SMEM_MAX


@pytest.mark.parametrize("shape,grid,per,rows,q", [
    ((4, 353, 256), (16, 8), 1, 162, 2),
    ((3, 428, 256), (16, 6), 1, 199, 2),
    ((2, 453, 256), (16, 8), 1, 106, 4),
])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_wgrad_plan_at_the_librispeech_shapes(shape, grid, per, rows, q,
                                              itemsize):
    """K = 31 at the LibriSpeech micro-batches: 16-channel tiles, each a
    cluster of 6-8 blocks of one item, 2 tap groups of 16 taps and 16
    row groups (128 threads), by TMA, with no partials in the
    workspace."""
    p = dw.wgrad_plan(*shape, 31, itemsize)
    assert (p.route, p.c_tile, p.grid, p.per, p.rows, p.q) == (
        "tma", 16, grid, per, rows, q)
    assert p.cluster and p.one_pass and p.splits <= dw.W_CLUSTER
    assert p.block == (4, 16, 2) and (p.kc, p.tap_groups) == (16, 2)
    assert p.ws_floats == dw.W_MAX_CTILES and p.smem_bytes <= dw.SMEM_MAX


def test_wgrad_plan_export_names_the_python_fields():
    """openeat_dwconv1d_wgrad_plan writes the C plan's fields in the order
    of WGRAD_PLAN_FIELDS, which wgrad_plan_fields reads from a plan (the
    card compares the two plans value for value)."""
    src = (nvcc.CSRC_DIR / dw.SOURCE).read_text()
    body = re.search(r"const long long v\[(\d+)\] = \{(.*?)\};", src,
                     re.S)
    names = [n.strip().removeprefix("w.") for n in body.group(2).split(",")]
    c_to_py = {"smem": "smem_bytes"}
    assert int(body.group(1)) == len(names)
    assert tuple(c_to_py.get(n, n) for n in names) == dw.WGRAD_PLAN_FIELDS
    assert f"i < {len(names)}; ++i) out[i] = v[i];" in src
    p = dw.wgrad_plan(4, 353, 256, 31, 2)
    fields = dw.wgrad_plan_fields(p)
    assert len(fields) == len(names)
    assert fields[dw.WGRAD_PLAN_FIELDS.index("groups")] == p.block[1]
    assert fields[dw.WGRAD_PLAN_FIELDS.index("cluster")] == 1


def test_wgrad_probe_variants_rebuild_each_design_step():
    """chip_wgrad_probe.py rebuilds the K = 31 wgrad's design steps as text
    substitutions of the shipped source; each finds its anchor (or raises)
    and gives a source of its own."""
    import chip_wgrad_probe

    srcs = chip_wgrad_probe.variants()
    shipped = (nvcc.CSRC_DIR / dw.SOURCE).read_text()
    assert srcs["shipped"] == shipped
    assert len(set(srcs.values())) == len(srcs)
    assert "w->kf = k == K_FIXED ? k : 0;" in srcs["run_time_route"]
    assert "constexpr bool CLUSTER = false;" in srcs["step_a"]
    assert "constexpr int W_WIDE_GROUPS = 32;" in srcs["cluster_256"]
    assert "wgrad_rows<KC, CLUSTER && G == 0>(" not in srcs["no_exit"]
    for name in ("shipped_stamps", "no_sums_stamps"):
        assert srcs[name].count("STAMP(") == 6 and "fma_probe" in srcs[name]
