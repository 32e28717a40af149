"""The port's own truncated-normal draw (`_trunc_normal_` in
openeat_torch/models/asr_model.py) on the CPU:
- at the lmhard drive's full width, `init_draw.draw` at seeds 777, 778
  and 779 gives the state sha256s that the H100 host (torch 2.11, AVX512)
  printed for the committed drives (run_flax778/host777,
  run_draw778/init_draw.txt, run_draw779/init_draw.txt), and at 777
  every one of the 620 per-tensor sha256s of that host's file;
- on small tensors the draw equals, bit for bit, the inverse-CDF
  sequence written out here, every value lies in [a, b], and the
  generator advances by exactly one `uniform_` of p.numel();
- no module of the port calls torch's own `trunc_normal_`.

These pin the bits: if this host's `erfinv_` ever rounds differently,
they fail.
"""

import json
import math
import os
import re

import pytest
import torch

from openeat_torch.config import load_config
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import _trunc_normal_
from openeat_torch.quality import init_draw
from openeat_torch.utils.common import make_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "openeat_torch", "quality", "results",
                       "h100_lmhard")
HOST777 = os.path.join(RESULTS, "run_flax778", "host777")
DICT = os.path.join(HOST777, "dict.txt")
CONFS = {777: os.path.join(HOST777, "conf_synth.json"),
         778: os.path.join(RESULTS, "run_draw778", "conf_synth.json"),
         779: os.path.join(RESULTS, "run_draw779", "conf_synth.json")}
RECORDS = {777: os.path.join(HOST777, "init_draw_777.txt"),
           778: os.path.join(RESULTS, "run_draw778", "init_draw.txt"),
           779: os.path.join(RESULTS, "run_draw779", "init_draw.txt")}
CARD_HOST_SHA = {
    777: "f9e9f1b24130c4c9cff93d9757d03ac72f5c7fa19d45a852d07e5e73ee22aca8",
    778: "04da5fddb90aeae23f2361f0e8bb84d649d9d62f8bb8a37a496a0a9ab2670c28",
    779: "d15d3d3bb67b5661b950beec12bc326f1ee8e15ec38240e174860423969e9b0c",
}


@pytest.mark.parametrize("seed", [777, 778, 779])
def test_full_width_draw_is_the_card_hosts(seed):
    with open(RECORDS[seed], encoding="utf-8") as f:
        assert f"seed {seed}, 620 tensors, 27248290 parameters, sha256 " \
               f"{CARD_HOST_SHA[seed]}" in f.read()
    calls: dict[str, str] = {}
    state = init_draw.draw(load_config(CONFS[seed]), len(load_dict(DICT)),
                           seed, calls)
    assert init_draw.state_sha256(state) == CARD_HOST_SHA[seed]
    if seed != 777:
        return
    with open(os.path.join(HOST777, "per_tensor_777_native.json"),
              encoding="utf-8") as f:
        theirs = json.load(f)
    groups = init_draw.differing(calls, init_draw.tensor_sha256(state),
                                 theirs)
    assert {g: n for g, (n, _) in groups.items()} == {
        "uniform_ erfinv_ mul_ add_ clamp_": 210, "normal_": 2,
        "uniform_": 24, "fill_": 93, "zero_": 291}
    assert {g: names for g, (_, names) in groups.items() if names} == {}


def _written_out(p: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    a, b = -2 * std, 2 * std

    def norm_cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    lo, hi = norm_cdf(a / std), norm_cdf(b / std)
    p.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    p.erfinv_()
    p.mul_(std * math.sqrt(2.0))
    p.add_(0.0)
    p.clamp_(min=a, max=b)
    return a, b


@pytest.mark.parametrize("shape,fan_in,seed", [
    ((7,), 7, 0), ((64, 32), 32, 1), ((3, 5, 4, 4), 80, 777),
    ((4, 16, 8), 16, 12345)])
def test_small_draw_is_the_inverse_cdf_sequence(shape, fan_in, seed):
    got = torch.empty(shape)
    gen = make_generator(seed)
    with torch.no_grad():
        _trunc_normal_(got, fan_in, gen)
    want = torch.empty(shape)
    want_gen = make_generator(seed)
    a, b = _written_out(want, fan_in, want_gen)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got >= a).all()) and bool((got <= b).all())
    one_uniform = make_generator(seed)
    torch.empty(got.numel()).uniform_(generator=one_uniform)
    assert torch.equal(gen.get_state(), one_uniform.get_state())
    assert torch.equal(gen.get_state(), want_gen.get_state())


def test_port_calls_no_torch_trunc_normal():
    call = re.compile(
        r"init\.trunc_normal_\s*\(|import .*\btrunc_normal_\b")
    found = []
    for root, _, files in os.walk(os.path.join(REPO, "openeat_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as f:
                    found += [f"{path}:{i}" for i, line in enumerate(f, 1)
                              if call.search(line)]
    assert found == []
