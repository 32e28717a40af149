"""Plain reference of the hybrid CTC/attention Conformer's training step.

Written from the recipe's description (OpenEAT / WeNet Conformer, the
repository's examples/*/conf/train_conformer.yaml) in torch, float32:

- frontend: kaldi fbank (25 ms povey frames every 10 ms, DC removal,
  pre-emphasis 0.97, |rfft_512|^2, 80 mel bins from 20 Hz, log floored
  at float32 eps; with wav_dither d the framed samples get d x N(0, 1)),
  per-utterance mean and variance normalization over the valid frames,
  SpecAugment (time and frequency spans zeroed), padded frames zero;
- encoder: conv2d x4 subsampling (two 3x3 stride-2 convs, ReLU, a linear
  over channels x bins), x sqrt(d), sinusoidal rows; blocks of half-step
  macaron FFN, rel-pos self-attention ((q+u)k + (q+v)p over the whole
  row of positions, no shift), the convolution module (pointwise, GLU,
  depthwise K, LayerNorm, swish, pointwise, padding masked), FFN and a
  final LayerNorm; LayerNorm eps 1e-12 in the blocks, 1e-5 after the
  stack and in the conv module;
- CTC over the head's log-softmax (torch's ctc_loss, blank 0, sum over
  the batch / B), a left and a right Transformer decoder with
  label-smoothed KL loss (eps 0.1, sum / B), mixed as 0.3 CTC + 0.7
  (0.7 left + 0.3 right);
- dropout 0.1 after every residual branch and inside every FFN, masks
  drawn from the run's dropout generator in the order the layers run
  (u = torch.rand(shape) in float32; keep u >= rate; scale 1/(1-rate));
- the update: gradients summed over micro-batches and divided by their
  count, one global norm clipped to grad_clip, Adam (0.9, 0.999, 1e-8)
  at the warm-up rate schedule(n) = lr sqrt(w) min(n^-1/2, n w^-3/2),
  n = max(updates so far, 1).

`Precision` decides the precision of the computation: float32 for the
reference; for the control, float8 e4m3 (one scale a tensor) wherever
the configuration's bfloat16 compute holds a tensor: the operands of
every product and convolution, and every activation (the features, the
outputs of the products, the norms and the embeddings, the residual
stream); parameters, norm statistics and softmax stay float32, as they
do in the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

NEG_FILL = -1.0e9
FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """fp8=True rounds a tensor to float8 e4m3 with a scale of amax / 448
    a tensor, in the forward; gradients flow through as if unrounded."""

    fp8: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (q - x).detach()


# ---------------------------------------------------------------- frontend

def mel_matrix(n_fft: int = 512, n_mels: int = 80, rate: float = 16000.0,
               low: float = 20.0) -> np.ndarray:
    """[n_fft/2 + 1, n_mels] kaldi triangular weights on the mel scale
    1127 ln(1 + f/700); the Nyquist row zero."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    half = n_fft // 2
    lo, hi = mel(low), mel(rate / 2)
    delta = (hi - lo) / (n_mels + 1)
    m = mel(np.arange(half) * rate / n_fft)[:, None]
    left = lo + np.arange(n_mels) * delta
    up = (m - left) / delta
    down = (left + 2 * delta - m) / delta
    out = np.zeros((half + 1, n_mels), np.float64)
    out[:half] = np.maximum(0.0, np.minimum(up, down))
    return out.astype(np.float32)


def fbank(wav: torch.Tensor, lens: torch.Tensor, noise=None,
          dither: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """wav [B, N] float32 samples (16-bit scale) -> ([B, T, 80], [B])."""
    flen, shift = 400, 160
    t = (wav.shape[1] - flen) // shift + 1
    idx = torch.arange(t, device=wav.device)[:, None] * shift \
        + torch.arange(flen, device=wav.device)[None, :]
    frames = wav[:, idx]
    if dither:
        frames = frames + dither * noise
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1 - 0.97),
                        frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    n = torch.arange(flen, dtype=torch.float64, device=wav.device)
    window = ((0.5 - 0.5 * torch.cos(2 * math.pi * n / (flen - 1)))
              ** 0.85).float()
    power = torch.fft.rfft(frames * window, n=512).abs() ** 2
    mel = torch.from_numpy(mel_matrix()).to(wav.device)
    feats = torch.log(torch.clamp(power @ mel,
                                  min=float(np.finfo(np.float32).eps)))
    return feats, (lens - flen) // shift + 1


def normalize(feats: torch.Tensor, flens: torch.Tensor) -> torch.Tensor:
    valid = (torch.arange(feats.shape[1], device=feats.device)[None]
             < flens[:, None])[..., None]
    x = torch.where(valid, feats, 0.0)
    n = flens.float().clamp(min=1)[:, None, None]
    mean = x.sum(1, keepdim=True) / n
    var = torch.where(valid, (x - mean) ** 2, 0.0).sum(1, keepdim=True) / n
    return torch.where(valid, (x - mean) / torch.sqrt(var + 1e-8), 0.0)


def spec_augment(feats, flens, gen, num_t, num_f, max_t, max_f):
    """Spans drawn as the recipe's SpecAugment draws them: per row, time
    starts floor(u * len) and lengths U[1, max_t], then frequency starts
    floor(u * 80) and lengths U[1, max_f]; the spans zeroed."""
    b, t, nf = feats.shape
    dev = feats.device

    def span(upper, n, max_len):
        u = torch.rand((b, n), generator=gen, device=dev)
        start = (u * upper.clamp(min=1).float()).long()
        return start, torch.randint(1, max_len + 1, (b, n), generator=gen,
                                    device=dev)

    ts, tl = span(flens[:, None], num_t, max_t)
    fs, fl = span(torch.full((b, 1), nf, device=dev), num_f, max_f)
    pt = torch.arange(t, device=dev)[None, None]
    pf = torch.arange(nf, device=dev)[None, None]
    tm = ((pt >= ts[..., None]) & (pt < (ts + tl)[..., None])).any(1)
    fm = ((pf >= fs[..., None]) & (pf < (fs + fl)[..., None])).any(1)
    x = torch.where(tm[:, :, None] | fm[:, None, :], 0.0, feats)
    valid = (torch.arange(t, device=dev)[None] < flens[:, None])[..., None]
    return torch.where(valid, x, 0.0)


def features(wav, lens, frontend: dict, gen):
    """The training features of a micro-batch, drawing from `gen` in the
    frontend's order (dither noise, then SpecAugment)."""
    dither = float(frontend.get("wav_dither", 0.0))
    noise = None
    if dither:
        t = (wav.shape[1] - 400) // 160 + 1
        noise = torch.randn((wav.shape[0], t, 400), generator=gen,
                            device=wav.device)
    feats, flens = fbank(wav, lens, noise, dither)
    feats = normalize(feats, flens)
    sa = frontend["spec_aug_conf"]
    if sa:
        feats = spec_augment(feats, flens, gen, sa["num_t_mask"],
                             sa["num_f_mask"], sa["max_t"], sa["max_f"])
    return feats, flens


# ---------------------------------------------------------------- model

class Model:
    """The forward of the model in `conf` over parameters `p` (a dict of
    float32 tensors by the recipe's parameter names)."""

    def __init__(self, p: dict, conf: dict, vocab: int, prec: Precision,
                 gen: torch.Generator | None, rate: float):
        self.p, self.conf, self.vocab = p, conf, vocab
        self.prec, self.gen, self.rate = prec, gen, rate
        self.d = conf["d_model"]
        self.h = conf["attention_heads"]

    def drop(self, x):
        if self.gen is None or self.rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u >= self.rate, x / (1.0 - self.rate), 0.0)

    def lin(self, x, name, bias=True):
        b = self.p[name + ".bias"] if bias else None
        return self.prec(F.linear(self.prec(x),
                                  self.prec(self.p[name + ".weight"]), b))

    def ln(self, x, name, eps):
        return self.prec(F.layer_norm(x, (x.shape[-1],),
                                      self.p[name + ".weight"],
                                      self.p[name + ".bias"], eps))

    def ffn(self, x, name):
        h = self.prec(F.silu(self.lin(x, name + ".w_1")))
        return self.lin(self.drop(h), name + ".w_2")

    @staticmethod
    def sinusoid(t, d, device):
        pos = torch.arange(t, dtype=torch.float32, device=device)
        i = torch.arange(d // 2, dtype=torch.float32, device=device)
        ang = pos[:, None] * torch.exp(-i * (2.0 / d) * math.log(10000.0))
        return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(t, d)

    def split(self, x):
        b, t, _ = x.shape
        return x.view(b, t, self.h, self.d // self.h).transpose(1, 2)

    def attend(self, scores, v, mask, name):
        """mask bool [B, 1|Tq, Tk], True = attend."""
        m = mask[:, None]
        a = torch.softmax(scores.masked_fill(~m, NEG_FILL), dim=-1)
        a = a.masked_fill(~m, 0.0)
        ctx = self.prec(torch.matmul(self.prec(a), self.prec(v)))
        b, h, t, dk = ctx.shape
        return self.lin(ctx.transpose(1, 2).reshape(b, t, h * dk),
                        name + ".linear_out")

    def mha(self, q_in, kv_in, mask, name):
        q = self.split(self.lin(q_in, name + ".linear_q"))
        k = self.split(self.lin(kv_in, name + ".linear_k"))
        v = self.split(self.lin(kv_in, name + ".linear_v"))
        s = self.prec(torch.matmul(self.prec(q),
                                   self.prec(k).transpose(-1, -2)))
        return self.attend(s / math.sqrt(self.d // self.h), v, mask, name)

    def rel_mha(self, x, mask, pe, name):
        dk = self.d // self.h
        q = self.split(self.lin(x, name + ".linear_q"))
        k = self.split(self.lin(x, name + ".linear_k"))
        v = self.split(self.lin(x, name + ".linear_v"))
        pos = self.split(self.lin(pe[None], name + ".linear_pos", False))
        u = self.p[name + ".pos_bias_u"][None, :, None, :]
        w = self.p[name + ".pos_bias_v"][None, :, None, :]
        s = self.prec(
            torch.matmul(self.prec(q + u), self.prec(k).transpose(-1, -2))
            + torch.matmul(self.prec(q + w),
                           self.prec(pos).transpose(-1, -2)))
        return self.attend(s / math.sqrt(dk), v, mask, name)

    def conv_module(self, x, valid, name):
        x = torch.where(valid, x, 0.0)
        x = self.prec(F.glu(self.lin(x, name + ".pointwise_conv1"), dim=-1))
        k = self.p[name + ".depthwise_conv.weight"]          # [K, C]
        pad = (k.shape[0] - 1) // 2
        y = F.conv1d(self.prec(x).transpose(1, 2),
                     self.prec(k).t()[:, None, :], padding=pad,
                     groups=x.shape[-1]).transpose(1, 2)
        y = self.prec(self.prec(y) + self.p[name + ".depthwise_conv.bias"])
        y = self.prec(F.silu(self.ln(y, name + ".norm", 1e-5)))
        return torch.where(valid, self.lin(y, name + ".pointwise_conv2"), 0.0)

    def encode(self, feats, flens):
        p, e = self.p, "encoder.embed."
        h = self.prec(feats[:, None])
        lens = flens
        for i in range(2):
            h = self.prec(F.relu(self.prec(F.conv2d(
                self.prec(h), self.prec(p[f"{e}Conv_{i}.weight"]),
                p[f"{e}Conv_{i}.bias"], stride=2))))
            lens = torch.div(lens - 3, 2, rounding_mode="floor") + 1
        b, c, t, f = h.shape
        x = self.prec(self.lin(h.permute(0, 2, 3, 1).reshape(b, t, f * c),
                               e + "Dense_0") * math.sqrt(self.d))
        pe = self.sinusoid(t, self.d, x.device)
        valid = (torch.arange(t, device=x.device)[None] < lens[:, None])
        mask = valid[:, None, :]
        for i in range(self.conf["encoder_num_blocks"]):
            n = f"encoder.encoders.layer_{i}."
            q = self.prec
            x = q(x + 0.5 * self.drop(self.ffn(
                self.ln(x, n + "norm_ff_macaron", 1e-12),
                n + "feed_forward_macaron")))
            x = q(x + self.drop(self.rel_mha(
                self.ln(x, n + "norm_mha", 1e-12), mask, pe,
                n + "self_attn")))
            x = q(x + self.drop(self.conv_module(
                self.ln(x, n + "norm_conv", 1e-12), valid[..., None],
                n + "conv_module")))
            x = q(x + 0.5 * self.drop(self.ffn(
                self.ln(x, n + "norm_ff", 1e-12), n + "feed_forward")))
            x = self.ln(x, n + "norm_final", 1e-12)
        return self.ln(x, "encoder.encoders.after_norm", 1e-5), lens

    def decode(self, which, ys_in, lens1, memory, mem_mask):
        n0 = f"decoder.{which}."
        L = ys_in.shape[1]
        x = self.prec(self.prec(F.embedding(ys_in, self.p[n0 + "embed.weight"]))
                      * math.sqrt(self.d)
                      + self.sinusoid(L, self.d, ys_in.device))
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=ys_in.device).tril()
        tmask = (torch.arange(L, device=ys_in.device)[None, None]
                 < lens1[:, None, None]) & causal[None]
        n_blocks = self.conf["decoder_num_blocks" if which == "left_decoder"
                             else "r_decoder_num_blocks"]
        for i in range(n_blocks):
            n = f"{n0}decoders.layer_{i}."
            h = self.ln(x, n + "norm1", 1e-12)
            x = self.prec(x + self.drop(self.mha(h, h, tmask,
                                                 n + "self_attn")))
            h = self.ln(x, n + "norm2", 1e-12)
            x = self.prec(x + self.drop(self.mha(h, memory, mem_mask,
                                                 n + "src_attn")))
            x = self.prec(x + self.drop(self.ffn(
                self.ln(x, n + "norm3", 1e-12), n + "feed_forward")))
        return self.lin(self.ln(x, n0 + "after_norm", 1e-12),
                        n0 + "output_layer")

    def loss(self, feats, flens, ys, ylens):
        """The joint loss of a micro-batch; ys [B, L] padded with -1."""
        c = self.conf
        enc, hlens = self.encode(feats, flens)
        logp = torch.log_softmax(self.lin(enc, "ctc.ctc_lo"), dim=-1)
        b, L = ys.shape
        pos = torch.arange(L, device=ys.device)[None]
        labels = torch.where(pos >= ylens[:, None], 0, ys)
        per = F.ctc_loss(logp.transpose(0, 1), labels, hlens, ylens,
                         blank=0, reduction="none", zero_infinity=True)
        repeats = ((labels[:, 1:] == labels[:, :-1])
                   & (pos[:, 1:] < ylens[:, None])).sum(1)
        per = torch.where(hlens >= ylens + repeats, per, 0.0)
        loss_ctc = per.sum() / b
        sos = self.vocab - 1
        mem_mask = (torch.arange(enc.shape[1], device=ys.device)[None]
                    < hlens[:, None])[:, None, :]
        left_in, left_out = sos_eos(ys, ylens, sos)
        rev = reverse(ys, ylens)
        right_in, right_out = sos_eos(rev, ylens, sos)
        left = self.decode("left_decoder", left_in, ylens + 1, enc, mem_mask)
        right = self.decode("right_decoder", right_in, ylens + 1, enc,
                            mem_mask)
        lsm = c["lsm_weight"]
        rw = c["reverse_weight"]
        att = (1 - rw) * smoothed_kl(left, left_out, lsm) \
            + rw * smoothed_kl(right, right_out, lsm)
        return c["ctc_weight"] * loss_ctc + (1 - c["ctc_weight"]) * att


def sos_eos(ys, lens, sos):
    """[y1..yn, -1...] -> ([sos, y1..yn, eos...], [y1..yn, eos, -1...])."""
    b, L = ys.shape
    pos = torch.arange(L + 1, device=ys.device)[None]
    ext = torch.cat([ys, ys.new_full((b, 1), -1)], 1)
    shifted = torch.cat([ys.new_full((b, 1), sos), ext[:, :-1]], 1)
    lens = lens[:, None]
    ys_in = torch.where(pos == 0, sos, torch.where(pos <= lens, shifted, sos))
    ys_out = torch.where(pos < lens, ext, torch.where(pos == lens, sos, -1))
    return ys_in, ys_out


def reverse(ys, lens):
    L = ys.shape[1]
    pos = torch.arange(L, device=ys.device)[None]
    src = (lens[:, None] - 1 - pos).clamp(0, L - 1)
    return torch.where(pos < lens[:, None], ys.gather(1, src), -1)


def smoothed_kl(logits, target, eps):
    b, _, v = logits.shape
    logp = torch.log_softmax(logits, dim=-1)
    valid = target != -1
    tgt = torch.where(valid, target, 0)
    on = logp.gather(-1, tgt[..., None])[..., 0]
    conf, off = 1.0 - eps, eps / (v - 1)
    ent = conf * math.log(conf) + (v - 1) * off * math.log(off)
    cross = conf * on + off * (logp.sum(-1) - on)
    return torch.where(valid, ent - cross, 0.0).sum() / b


# ---------------------------------------------------------------- update

def warmup_lr(lr: float, warmup: int, n: int) -> float:
    w = max(int(warmup), 1)
    s = max(float(n), 1.0)
    return lr * w ** 0.5 * min(s ** -0.5, s * w ** -1.5)


@dataclass
class Adam:
    lr: float
    warmup: int
    clip: float
    n: int = 0

    def __post_init__(self):
        self.m: dict = {}
        self.v: dict = {}
        self.last_norms: dict[str, float] = {}

    def step(self, params: dict) -> None:
        """One update; `last_norms` then holds each leaf's norm of the
        clipped gradient."""
        grads = {k: p.grad for k, p in params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if not torch.isfinite(norm):
            self.last_norms = {k: math.inf for k in params}
            return
        scale = min(1.0, self.clip / max(float(norm), 1e-12))
        self.last_norms = {k: float(g.double().norm()) * scale
                           for k, g in grads.items()}
        rate = warmup_lr(self.lr, self.warmup, self.n)
        self.n += 1
        b1, b2 = 1 - 0.9 ** self.n, 1 - 0.999 ** self.n
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * scale
                m = self.m.get(k, torch.zeros_like(p)) * 0.9 + 0.1 * g
                v = self.v.get(k, torch.zeros_like(p)) * 0.999 + 0.001 * g * g
                self.m[k], self.v[k] = m, v
                p -= rate / b1 * m / (torch.sqrt(v) / math.sqrt(b2) + 1e-8)
