"""The operation and byte counts against counts made by hand and by
torch's FLOP counter at tiny shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, weights
from perfbench.reference import conformer as ref

H100 = flops.peaks("NVIDIA H100 80GB HBM3")
TINY = dict(d_model=8, attention_heads=2, linear_units=16,
            encoder_num_blocks=2, decoder_num_blocks=1,
            r_decoder_num_blocks=1, cnn_module_kernel=3, ctc_weight=0.3,
            lsm_weight=0.1, reverse_weight=0.3)


def tiny_params(vocab):
    from openeat_torch.models.asr_model import build_asr_model
    model = build_asr_model(TINY, 80, vocab)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return weights.draw(shapes, 1, torch.device("cpu"))


@pytest.mark.parametrize("frames,tokens", [(40, 5), (23, 1), (61, 9)])
def test_forward_flops_equal_torch_counter(frames, tokens):
    vocab = 11
    model = ref.Model(tiny_params(vocab), TINY, vocab, ref.Precision(), None,
                      0.0)
    feats = torch.randn(1, frames, 80)
    with FlopCounterMode(display=False) as fc:
        model.loss(feats, torch.tensor([frames]),
                   torch.randint(2, vocab - 1, (1, tokens)),
                   torch.tensor([tokens]))
    assert fc.get_total_flops() == (
        flops.conformer_forward_flops(frames, tokens, TINY, vocab)
        + flops.pos_flops(frames, TINY))


def test_subsampling_by_hand():
    # frames 15 -> 7 -> 3; 80 bins -> 39 -> 19
    assert flops.subsampled(15) == 3
    m = dict(TINY, encoder_num_blocks=0, decoder_num_blocks=0,
             r_decoder_num_blocks=0)
    d, t1, t = 8, 7, 3
    sub = 2 * d * t1 * 39 * 9 + 2 * d * d * 9 * t * 19 + 2 * t * 19 * d * d
    ctc = 2 * t * d * 5
    head = 2 * (0 + 1) * d * 5           # the left decoder's output layer
    assert flops.conformer_forward_flops(15, 0, m, 5) == sub + ctc + head


def test_dwconv_bound_by_hand():
    # [8, 212, 256] K=15 float32: 4 (8*212*256 + 15*256 + 8*198*256) bytes
    nbytes = 4 * (8 * 212 * 256 + 15 * 256 + 8 * 198 * 256)
    assert flops.dwconv_bound_s("fwd", 8, 212, 256, 15, 4, H100) \
        == pytest.approx(nbytes / 3.35e12)
    assert flops.dwconv_bound_s("dgrad", 8, 212, 256, 15, 4, H100) \
        == pytest.approx(nbytes / 3.35e12)
    wbytes = 2 * (4 * 353 * 256 + 4 * 323 * 256 + 31 * 256)
    assert flops.dwconv_bound_s("wgrad", 4, 353, 256, 31, 2, H100) \
        == pytest.approx(wbytes / 3.35e12)


def test_dwconv_bound_by_rate_when_compute_bound():
    # one channel, a long kernel: 2*T*K operations beat the bytes
    b, t_in, c, k = 1, 4096 + 1023, 1, 1024
    ops = 2 * 4096 * 1024
    assert flops.dwconv_bound_s("fwd", b, t_in, c, k, 4, H100) \
        == pytest.approx(ops / 67e12)


def test_ctc_bound_by_hand():
    # [14, 198, 49]: 2 x 14*198*49 floats = 0.3244 us at 3.35 TB/s
    assert flops.ctc_bound_s(14, 198, 49, H100) * 1e6 \
        == pytest.approx(2 * 4 * 14 * 198 * 49 / 3.35e12 * 1e6)


def test_peaks_by_name():
    assert H100["bf16_flops"] == 989e12
    assert flops.peaks("some other card") is None
