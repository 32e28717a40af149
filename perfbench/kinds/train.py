"""Training cells: the recipe's training path, driven as bin.train drives
an epoch.

A WAV manifest -> `AudioDataset` (dynamic batches) / `PrefetchLoader`
(collate threads, a shuffled order an epoch) -> `DeviceFeeder`
(on-device fbank and SpecAugment) -> `Executor.train` stepping the step
of `build_train_step` (forward, backward, clip, Adam). One object is
built at set-up and carries through: it first takes the `check_steps`
updates the reference follows (the batches of `check_batches`, fed by a
loader of their own); then the epoch's loader starts and
`warm_updates` updates prime it; the window runs on in the same epoch,
which lasts as long as the real corpus's.

Set-up also warms every batch shape the epoch can feed: cuDNN builds an
execution plan for each new shape of the subsampling's 2-D convolutions
(forward, data and weight gradients) and caches it, tens of
milliseconds a shape with the device idle; a run over the real corpus
builds them in its first epoch and reuses them in every later one.
`warm_shapes` runs the model's first stack of 2-D convolutions forward
and backward on zeros of each (rows, frames) the epoch's batches give,
at every length their speed perturbation can give. The check's batches,
the longest and the shortest utterances, take the caching allocator to
its peak before the window. Nothing else is built per shape (the
kernels are built once, no cuDNN search, no torch.compile).

Seeds, from the run's: the weights (perfbench/weights.py), the third
batch the check follows, the loader's batch order (seed + epoch), the
frontend's generators, the dropout generator. The corpus comes from the
traffic's pool seed.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import math
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import check, flops, weights
from perfbench import corpus as corpus_lib
from perfbench.reference import batches as ref_batches
from perfbench.reference import conformer as ref
from perfbench.reference import speed as ref_speed

BREAKDOWN_UPDATES = 6
TRACE_SECONDS = 15.0


def sub_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1)[0])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Record:
    """The harness's own spans and counts over a stretch of updates."""

    input_wait_s: list[float] = field(default_factory=list)
    updates: int = 0
    skipped: int = 0
    audio_s: float = 0.0
    flops: float = 0.0
    fwd_bwd_s: list[float] = field(default_factory=list)
    update_s: list[float] = field(default_factory=list)
    # (keys, features_length on the device, padded frames) of each batch,
    # read after the window for the FLOPs at the lengths the program ran
    lengths: list = field(default_factory=list)


class Picked:
    """Some batches of a dataset, in the order given."""

    def __init__(self, dataset, indices: list[int]):
        self.dataset, self.indices = dataset, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


class TrainRun:
    """The program's training objects for one cell and seed."""

    def __init__(self, cell, seed: int, device: torch.device,
                 cache_root: Path | None = None):
        from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                                   PrefetchLoader)
        from openeat_torch.dataset.text import load_dict
        from openeat_torch.models.asr_model import build_asr_model
        from openeat_torch.ops.frontend import FrontendConfig
        from openeat_torch.parallel.train_step import (TrainState,
                                                       build_eval_step,
                                                       build_train_step)
        from openeat_torch.pipeline import DeviceFeeder
        from openeat_torch.utils.executor import Executor
        from openeat_torch.utils.optim import build_optimizer

        self._loader_cls, self._feeder_cls = PrefetchLoader, DeviceFeeder
        self.cell, self.seed, self.device = cell, int(seed), device
        c = cell.config
        self.mc, self.dc = c["model_conf"], c["dataset_conf"]
        self.cc = c["collate_conf"]
        self.fe = fe = self.cc.get("feature_extraction_conf", {})
        self.accum = int(c.get("accum_grad", 1))
        self.clip = float(c.get("grad_clip", 5.0))
        self.workers = int(cell.traffic.get("loader_workers", 4))
        t0 = time.perf_counter()
        self.corpus = corpus_lib.make_corpus(
            cell.traffic, int(c["vocab_size"]), cache_root)
        self.timings = {"corpus_s": time.perf_counter() - t0}
        char_dict = load_dict(str(self.corpus.dict_path))
        self.vocab = len(char_dict)
        dc = self.dc
        self.ds = AudioDataset(
            str(self.corpus.manifest), char_dict, None,
            max_length=dc.get("max_length", 10240),
            min_length=dc.get("min_length", 0),
            token_max_length=dc.get("token_max_length", 200),
            token_min_length=dc.get("token_min_length", 0),
            batch_type=dc.get("batch_type", "dynamic"),
            batch_size=dc.get("batch_size", 12),
            max_frames_in_batch=dc["max_frames_in_batch"],
            sort=dc.get("sort", True), seed=self.seed)
        self.collate = AudioCollate(
            resample_rate=fe.get("resample_rate", 16000),
            speed_perturb_rate=fe.get("speed_perturb_rate", 0.0),
            speeds=tuple(fe.get("speeds", (0.9, 1.1, 0.1))), seed=self.seed)
        self.frontend = FrontendConfig.from_collate_conf(self.cc)
        self.timings["dataset_s"] = time.perf_counter() - t0
        model = build_asr_model(self.mc, fe.get("mel_bins", 80), self.vocab)
        model.to(device)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.theta0 = weights.draw(shapes, sub_seed(seed, 1), device)
        model.load_state_dict(self.theta0)
        self.warmup = int(c.get("warmup_steps") or
                          int(c.get("warmup_epoch", 0) * len(self.ds)))
        self.lr = float(c["optim_conf"]["lr"])
        opt, self.schedule = build_optimizer(model, self.lr, self.warmup,
                                             c.get("optim", "adam"))
        self.state = TrainState(model, opt)
        self.executor = Executor(
            self._recording(build_train_step(self.schedule, self.accum,
                                             self.clip)),
            build_eval_step(model), self.schedule, log_interval=1 << 62,
            logger=logging.getLogger("perfbench.quiet"))
        self.fseed = sub_seed(seed, 4)
        self.dseed = sub_seed(seed, 3)
        self.dropout_gen = torch.Generator(device=device).manual_seed(
            self.dseed)
        self.rec = Record()
        self.on_step = None
        self.index = self.corpus.index()
        # the check's batches, as the reference works them out
        self.batches = ref_batches.batches_of(
            self.corpus.samples, self.corpus.tokens, dc)
        self.check_idx = ref_batches.check_batches(
            len(self.batches), self.seed, int(cell.limits["check_steps"]))
        self.observed: list = []        # (keys, frames) of each checked batch
        self.stream = None

    # ---- feeding

    def _feeder(self, dataset, shuffle: bool, loader_seed: int,
                frontend_seed: int):
        loader = self._loader_cls(dataset, self.collate, self.workers,
                                  shuffle_batches=shuffle, seed=loader_seed)
        return self._feeder_cls(loader, self.frontend, self.device,
                                train=True, seed=frontend_seed,
                                accum_grad=self.accum)

    def _stream(self):
        """(keys, device batch) of epoch after epoch, as bin.train builds
        a loader and a feeder an epoch."""
        epoch = 0
        while True:
            yield from self._feeder(self.ds, True, self.seed + epoch,
                                    self.fseed + 1 + epoch)
            epoch += 1

    def _account(self, keys: list[str], batch: dict, lengths: bool) -> None:
        rows = [self.index[k] for k in keys]
        self.rec.audio_s += float(self.corpus.samples[rows].sum()) \
            / corpus_lib.SAMPLE_RATE
        if lengths:
            self.rec.lengths.append((rows, batch["features_length"],
                                     batch["features"].shape[-2]))

    def feed(self, n: int | None = None, deadline: float | None = None,
             span: bool = False, lengths: bool = False, source=None):
        """Batches from `source` (the epoch stream by default): `n` of
        them, or until `deadline` (the host clock) has passed; the wait
        for each is an input_wait span."""
        if source is None:
            if self.stream is None:
                self.stream = self._stream()
            source = self.stream
        i = 0
        while (n is None or i < n) and (deadline is None
                                        or time.perf_counter() < deadline):
            t = time.perf_counter()
            with (torch.profiler.record_function("perfbench.input_wait")
                  if span else contextlib.nullcontext()):
                try:
                    keys, batch = next(source)
                except StopIteration:
                    return
            self.rec.input_wait_s.append(time.perf_counter() - t)
            self._account(keys, batch, lengths)
            i += 1
            yield batch

    def _recording(self, step):
        def train_step(state, batch, generator, chunk_generator=None):
            metrics = step(state, batch, generator, chunk_generator)
            self.rec.updates += 1
            self.rec.skipped += int(float(metrics["skipped"]))
            if self.on_step is not None:
                self.on_step(metrics)
            return metrics
        return train_step

    def flops_of(self, rec: Record) -> float:
        """Model FLOPs of a record's batches (3x the forward), each
        utterance at the frames the program fed it."""
        fwd = 0
        for rows, flens, padded in rec.lengths:
            frames = flens.reshape(-1)[:len(rows)].tolist()
            fwd += sum(flops.conformer_forward_flops(
                int(f), int(self.corpus.tokens[i]), self.mc, self.vocab)
                for i, f in zip(rows, frames))
            fwd += self.accum * flops.pos_flops(padded, self.mc)
        return 3.0 * fwd

    def shapes(self) -> set[tuple[int, int]]:
        """(rows, fbank frames) of every micro-batch the epoch can feed,
        at each padded width its utterances' speeds can give."""
        speeds = self.speeds()
        bucket = ref_batches.WAV_BUCKET
        out = set()
        for rows in self.batches:
            n = [int(self.corpus.samples[i]) for i in rows]
            lo = max(ref_speed.length(x, max(speeds)) for x in n)
            hi = max(ref_speed.length(x, min(speeds)) for x in n)
            b = -(-len(rows) // self.accum)
            for w in range(-(-lo // bucket) * bucket,
                           -(-hi // bucket) * bucket + 1, bucket):
                out.add((b, ref_speed.frames(w)))
        return out

    def warm_shapes(self) -> int:
        """The model's first stack of 2-D convolutions (the subsampling),
        forward and backward on zeros of every shape of `shapes`, so that
        cuDNN holds a plan for each; the number of shapes warmed."""
        model = self.state.model
        convs = next((c for c in ([x for x in m.children()
                                   if isinstance(x, torch.nn.Conv2d)]
                                  for m in model.modules()) if c), [])
        if not convs:
            return 0
        mel = int(self.fe.get("mel_bins", 80))
        shapes = sorted(self.shapes())
        for b, f in shapes:
            h = torch.zeros((b, 1, f, mel), device=self.device)
            for conv in convs:
                h = torch.relu(conv(h))
            h.float().sum().backward()
        model.zero_grad(set_to_none=True)
        sync(self.device)
        return len(shapes)

    # ---- phases

    def program_check(self) -> check.Readings:
        """The check's updates, through Executor.train; their losses, the
        first clipped gradient (from Adam's first moment after one update,
        0.1 of it), the change of every leaf, and each batch's keys and
        frames (the speeds the collate drew show in them)."""
        r = check.Readings()
        params = dict(self.state.model.named_parameters())
        source = iter(self._feeder(Picked(self.ds, self.check_idx), False,
                                   self.seed, self.fseed))

        def observed():
            for keys, batch in source:
                frames = batch["features_length"].reshape(-1)[:len(keys)]
                self.observed.append((list(keys), frames.tolist()))
                yield keys, batch

        def on_step(metrics):
            r.losses.append(float(metrics["loss"]))
            if len(r.losses) == 1:
                st = self.state.optimizer.state
                r.grad_norms = {n: float(st[p]["exp_avg"].double().norm())
                                / 0.1 if p in st else math.nan
                                for n, p in params.items()}

        self.on_step = on_step
        try:
            self.executor.train(self.state, self.feed(source=observed()),
                                self.dropout_gen)
        finally:
            self.on_step = None
        with torch.no_grad():
            r.delta_norms = {
                n: float((p.double() - self.theta0[n].double()).norm())
                for n, p in params.items()}
        return r

    def warm_up(self, n: int) -> None:
        """`n` updates from the epoch's stream: its loader is primed."""
        if n > 0:
            self.executor.train(self.state, self.feed(n=n), self.dropout_gen)
        sync(self.device)

    def window(self, seconds: float, tracing: bool, lengths: bool = False):
        """Updates until `seconds` have passed; (window_s, record, profile
        or None)."""
        self.rec = Record()
        prof = None
        if tracing:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        try:
            sync(self.device)
            t0 = time.perf_counter()
            with (torch.profiler.record_function("perfbench.window")
                  if tracing else contextlib.nullcontext()):
                self.executor.train(
                    self.state, self.feed(deadline=t0 + seconds,
                                          span=tracing, lengths=lengths),
                    self.dropout_gen)
                sync(self.device)
            window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return window_s, self.rec, prof

    def breakdown(self, into: Record, n: int = BREAKDOWN_UPDATES) -> None:
        """`n` updates of the functions build_train_step composes, each
        phase ended by a synchronise: forward + backward (over the
        micro-batches) and clip + Adam; the times go `into` a record."""
        from openeat_torch.modules.dropout import set_generator
        from openeat_torch.parallel.train_step import (_loss_and_grads,
                                                       apply_update, asr_loss)
        model = self.state.model
        model.train()
        set_generator(model, self.dropout_gen)
        self.rec = Record()
        batches = list(self.feed(n=n))
        for batch in batches:
            sync(self.device)
            t0 = time.perf_counter()
            model.zero_grad(set_to_none=True)
            _loss_and_grads(model, batch, self.accum, asr_loss)
            sync(self.device)
            t1 = time.perf_counter()
            apply_update(self.state, self.schedule, self.clip)
            sync(self.device)
            into.fwd_bwd_s.append(t1 - t0)
            into.update_s.append(time.perf_counter() - t1)

    def free_program(self) -> None:
        """Stop the loader threads and free the program's state."""
        if self.stream is not None:
            self.stream.close()
        self.executor = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference

    def speeds(self) -> list[float]:
        """The speeds an utterance can play at in the collate."""
        out = [1.0]
        if float(self.fe.get("speed_perturb_rate", 0.0)) > 0:
            lo, hi, step = self.fe.get("speeds", (0.9, 1.1, 0.1))
            out += [float(s) for s in np.arange(lo, hi + step / 2, step)]
        return out

    def followed_speeds(self) -> list[dict[int, float]] | None:
        """Each checked batch's speed by entry, worked out from the
        frames the program fed (each speed gives its own length); None
        where the program's batch holds other entries than the
        reference's, or a length no speed gives."""
        if len(self.observed) != len(self.check_idx):
            return None
        speeds, out = self.speeds(), []
        for b, (keys, frames) in zip(self.check_idx, self.observed):
            rows = self.batches[b]
            seen = dict(zip(keys, frames))
            if sorted(seen) != sorted(self.corpus.keys[i] for i in rows):
                return None
            got = {i: ref_speed.infer(int(self.corpus.samples[i]),
                                      seen[self.corpus.keys[i]], speeds)
                   for i in rows}
            if any(v is None for v in got.values()):
                return None
            out.append(got)
        return out

    def _ref_micro(self, mb: ref_batches.MicroBatch, speed: dict):
        ids = self.corpus.token_ids
        wav = np.zeros((len(mb.rows), mb.wav_width), np.float32)
        ys = np.full((len(mb.rows), mb.token_width), -1, np.int64)
        lens = []
        for j, i in enumerate(mb.rows):
            x = ref_speed.perturb(self.corpus.read(i), speed[i], self.device)
            wav[j, :len(x)] = x
            lens.append(len(x))
            ys[j, :len(ids[i])] = ids[i]
        dev = self.device
        ylens = torch.as_tensor([len(ids[i]) for i in mb.rows], device=dev)
        return (torch.from_numpy(wav).to(dev), torch.as_tensor(lens,
                                                               device=dev),
                torch.from_numpy(ys).to(dev), ylens)

    def reference(self, prec: ref.Precision,
                  half: bool = False) -> check.Readings:
        """The reference's updates over the check's batches, from the same
        weights, corpus and seeds, each utterance at the speed the
        program's collate drew. half=True is a planted fault: each
        micro-batch's loss over its first half of rows only. No losses
        where the program's batches are not the reference's."""
        if self.cc.get("spec_sub") or self.cc.get("feature_dither") \
                or self.cc.get("normalization") is False:
            raise NotImplementedError("the reference frontend covers fbank, "
                                      "normalization, dither, SpecAugment")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        r = check.Readings()
        speeds = self.followed_speeds()
        if speeds is None:
            return r
        dev = self.device
        fgen = torch.Generator(device=dev).manual_seed(self.fseed)
        dgen = torch.Generator(device=dev).manual_seed(self.dseed)
        params = {n: t.detach().clone().requires_grad_(True)
                  for n, t in self.theta0.items()}
        adam = ref.Adam(self.lr, self.warmup, self.clip)
        frontend = {"wav_dither": self.fe.get("wav_dither", 0.0),
                    "spec_aug_conf": (self.cc.get("spec_aug_conf")
                                      if self.cc.get("spec_aug") else None)}
        for b, speed in zip(self.check_idx, speeds):
            lens = {i: ref_speed.length(int(self.corpus.samples[i]), s)
                    for i, s in speed.items()}
            micro = []
            for mb in ref_batches.micro_batches(
                    self.batches[b], lens, self.corpus.tokens, self.accum):
                wav, wlens, ys, ylens = self._ref_micro(mb, speed)
                feats, flens = ref.features(wav, wlens, frontend, fgen)
                micro.append((feats, flens, ys, ylens))
            model = ref.Model(params, self.mc, self.vocab, prec, dgen,
                              float(self.mc.get("dropout_rate", 0.1)))
            for p in params.values():
                p.grad = None
            total = 0.0
            for feats, flens, ys, ylens in micro:
                if half:
                    k = max(1, feats.shape[0] // 2)
                    feats, flens, ys, ylens = feats[:k], flens[:k], ys[:k], \
                        ylens[:k]
                loss = model.loss(feats, flens, ys, ylens)
                loss.backward()
                total += float(loss.detach())
                del loss
            if self.accum > 1:
                for p in params.values():
                    p.grad /= self.accum
            r.losses.append(total / self.accum)
            adam.step(params)
            if len(r.losses) == 1:
                r.grad_norms = dict(adam.last_norms)
        with torch.no_grad():
            r.delta_norms = {n: float((p.double() - self.theta0[n].double())
                                      .norm()) for n, p in params.items()}
        return r


def kernel_counts() -> dict:
    """The program's launch counters by shape (ops/depthwise_conv.py,
    ops/ctc_loss.py), copied."""
    from openeat_torch.ops import ctc_loss as ctc
    from openeat_torch.ops import depthwise_conv as dw
    return {"fwd": dict(dw.depthwise_conv1d.shape_launches),
            "dgrad": dict(dw.depthwise_conv1d_dgrad.shape_launches),
            "wgrad": dict(dw.depthwise_conv1d_wgrad.shape_launches),
            "ctc": {**ctc.ctc_dp_shared.shape_launches,
                    **{("global",) + k: v
                       for k, v in ctc.ctc_dp_global.shape_launches.items()}}}


def counts_between(before: dict, after: dict) -> dict:
    return {entry: {k: n - before[entry].get(k, 0)
                    for k, n in after[entry].items()
                    if n - before[entry].get(k, 0) > 0}
            for entry in after}


def ctc_launches(launches: dict) -> dict[str, int]:
    """Launches of K1 (ctc_dp_shared) and K2 (ctc_dp_global) in a count
    of kernel_counts' kind."""
    ctc = launches.get("ctc", {})
    k2 = sum(n for k, n in ctc.items() if k and k[0] == "global")
    return {"ctc_shared_launches": sum(ctc.values()) - k2,
            "ctc_global_launches": k2}


@dataclass
class Context:
    """What the per-layer readers (perfbench/metrics/*.py) read: the
    measured window's record (untraced), the traced window's trace,
    record and launches, and the timed breakdown."""

    kind: str
    record: Record
    window_s: float
    trace: object = None          # perfbench.trace.Trace of the traced window
    traced: Record | None = None
    launches: dict = field(default_factory=dict)
    peaks: dict | None = None
    itemsize: int = 2


def run(cell, seed: int, seconds: float, tracing: bool,
        device: torch.device, t_start: float,
        cache_root: Path | None = None) -> dict:
    """One run of a training cell. Returns the end-to-end numbers, the
    readers' context, the numbers compared and the device's peak.

    The measured window runs untraced in both modes; with tracing a
    second window of up to TRACE_SECONDS runs under the profiler (which
    slows the host's launches, so the rates and shares of the host's
    clock come from the first), then the timed breakdown."""
    from perfbench.trace import Trace
    t0 = time.perf_counter()
    tr = TrainRun(cell, seed, device, cache_root)
    t1 = time.perf_counter()
    before = kernel_counts()
    mine = tr.program_check()
    checked = ctc_launches(counts_between(before, kernel_counts()))
    t2 = time.perf_counter()
    n_shapes = tr.warm_shapes()
    t3 = time.perf_counter()
    tr.warm_up(int(cell.traffic.get("warm_updates", 2)))
    setup_s = time.perf_counter() - t_start
    timings = dict(tr.timings, imports_s=t0 - t_start, build_s=t1 - t0,
                   check_steps_s=t2 - t1, shapes_s=t3 - t2,
                   warm_up_s=time.perf_counter() - t3)
    window_s, rec, _ = tr.window(seconds, False, lengths=tracing)
    trace, traced, launches = None, None, {}
    if tracing:
        rec.flops = tr.flops_of(rec)
        rec.lengths = []
        before = kernel_counts()
        traced_s, traced, prof = tr.window(min(seconds, TRACE_SECONDS), True)
        launches = counts_between(before, kernel_counts())
        t5 = time.perf_counter()
        trace = Trace.from_profile(prof, "perfbench.window")
        del prof
        timings["trace_read_s"] = time.perf_counter() - t5
        tr.breakdown(rec)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr.free_program()
    t4 = time.perf_counter()
    theirs = tr.reference(ref.Precision())
    timings["reference_s"] = time.perf_counter() - t4
    numbers = dict(check.compare(mine, theirs), **checked)
    itemsize = 2 if cell.config["model_conf"].get(
        "compute_dtype", "bfloat16") == "bfloat16" else 4
    ctx = Context("train", rec, window_s, trace, traced, launches,
                  flops.peaks(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else ""),
                  itemsize)
    runs = [rec] + ([traced] if traced is not None else [])
    return {
        "end_to_end": {"train_audio_s_per_s": rec.audio_s / window_s,
                       "setup_s": setup_s},
        "context": ctx, "attempted": sum(x.updates for x in runs),
        "failed": sum(x.skipped for x in runs),
        "numbers": numbers, "memory_peak_bytes": peak,
        "notes": {"numbers": numbers,
                  "updates": rec.updates, "audio_s": rec.audio_s,
                  "traced_updates": traced.updates if traced else None,
                  "timings": timings, "batches_per_epoch": len(tr.ds),
                  "shapes_warmed": n_shapes,
                  "check_batches": tr.check_idx, "window_s": window_s,
                  "median_input_wait_ms": 1e3 * statistics.median(
                      rec.input_wait_s) if rec.input_wait_s else None}}
