"""The quality drive's result files. Port of the inline Python of
benchmarks/run_recipe_tpu.sh, as functions, so that
openeat_torch/quality/run_recipe.sh stays a thin list of stages:

- collect: the CER of each tag from its `cer_<tag>.txt` (the last
  `Overall -> x.xx %` line) into results.json or results_lm.json
  (`:159-170`, `:226-238`);
- significance: the five paired comparisons of stage 7 through
  openeat_torch.tools.compare_wer into results_significance.json
  (`:240-267`);
- int8: the int8 attention-rescoring decode's CER and its paired
  comparison with the float one into results_int8.json (the port's
  addition; outside the gate);
- adversarial: stage 9's CERs and comparisons on test_reverb and
  test_long into results_adversarial.json (`:306-341`);
- streaming: the streamed drive's three CERs and its paired comparison
  of streamed against offline rescoring into results_streaming.json
  (benchmarks/run_streaming_hard.sh `:121-138`);
- moe: the MoE drive's two CERs into results_moe.json
  (benchmarks/run_moe_hard.sh `:95-104`).

    python -m openeat_torch.quality.results collect EXP OUT TAG...
    python -m openeat_torch.quality.results significance EXP REF
    python -m openeat_torch.quality.results int8 EXP REF
    python -m openeat_torch.quality.results adversarial EXP DATA
    python -m openeat_torch.quality.results streaming EXP REF
    python -m openeat_torch.quality.results moe EXP
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]
LM_TAGS = ["rescoring_ngram", "rescoring_translm"]
INT8_TAG = "attention_rescoring_int8"
ADVERSARIAL_SPLITS = ["test_reverb", "test_long"]
ADVERSARIAL_TAGS = ["ctc_greedy_search", "attention_rescoring",
                    "rescoring_ngram"]

# (name, hypothesis tag A, hypothesis tag B): is A worse than B?
SIGNIFICANCE_PAIRS = [
    ("greedy_vs_rescoring", "ctc_greedy_search", "attention_rescoring"),
    ("greedy_vs_prefix", "ctc_greedy_search", "ctc_prefix_beam_search"),
    ("attention_vs_rescoring", "attention", "attention_rescoring"),
    ("rescoring_vs_ngram_fusion", "attention_rescoring", "rescoring_ngram"),
    ("rescoring_vs_translm_fusion", "attention_rescoring",
     "rescoring_translm"),
]
STREAM_TAGS = ["offline_ctc_greedy_search", "offline_attention_rescoring",
               "streamed"]
STREAM_PAIR = ("streamed_vs_offline_rescoring", "streamed",
               "offline_attention_rescoring")
MOE_TAGS = ["ctc_greedy_search", "attention_rescoring"]
MOE = "results_moe.json"
ADVERSARIAL_PAIRS = [
    ("greedy_vs_rescoring", "ctc_greedy_search", "attention_rescoring"),
    ("rescoring_vs_ngram_fusion", "attention_rescoring", "rescoring_ngram"),
]

_OVERALL = re.compile(r"Overall.*?(\d+\.\d+)")


def overall_cer(path: str) -> float | None:
    """The CER of the last Overall line of a compute_wer report."""
    with open(path, encoding="utf-8") as f:
        found = _OVERALL.findall(f.read())
    return float(found[-1]) if found else None


def _dump(obj: dict, out: str) -> None:
    with open(out, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def collect(exp_dir: str, tags: list[str], out: str) -> dict:
    """{tag: CER of exp_dir/cer_<tag>.txt}, written to `out`."""
    res = {tag: overall_cer(os.path.join(exp_dir, f"cer_{tag}.txt"))
           for tag in tags}
    _dump(res, out)
    return res


def _tool(name: str, *args: str, stdout=None) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", f"openeat_torch.tools.{name}", *args],
        stdout=subprocess.PIPE if stdout is None else stdout, text=True,
        check=True)
    return proc.stdout


def compare(ref: str, hyp_a: str, hyp_b: str) -> dict:
    """compare_wer's paired bootstrap and sign test of A against B."""
    return json.loads(_tool("compare_wer", ref, hyp_a, hyp_b))


def _hyp(exp_dir: str, tag: str) -> str:
    return os.path.join(exp_dir, f"hyp_{tag}.txt")


def significance(exp_dir: str, ref: str) -> dict:
    """Stage 7: every pair of SIGNIFICANCE_PAIRS, written to
    exp_dir/results_significance.json."""
    out = {}
    for name, a, b in SIGNIFICANCE_PAIRS:
        out[name] = compare(ref, _hyp(exp_dir, a), _hyp(exp_dir, b))
        print(name, json.dumps(out[name]))
    _dump(out, os.path.join(exp_dir, "results_significance.json"))
    return out


def int8(exp_dir: str, ref: str) -> dict:
    """The int8 rescoring decode's CER and its comparison with the
    float rescoring, written to exp_dir/results_int8.json."""
    out = {INT8_TAG: overall_cer(os.path.join(exp_dir,
                                              f"cer_{INT8_TAG}.txt")),
           "rescoring_vs_int8": compare(
               ref, _hyp(exp_dir, "attention_rescoring"),
               _hyp(exp_dir, INT8_TAG))}
    print(json.dumps(out))
    _dump(out, os.path.join(exp_dir, "results_int8.json"))
    return out


def adversarial(exp_dir: str, data_dir: str) -> dict:
    """Stage 9: score each adversarial split's hypotheses into
    cer_<split>_<tag>.txt and compare the mode pairs, written to
    exp_dir/results_adversarial.json."""
    out = {}
    for split in ADVERSARIAL_SPLITS:
        ref = os.path.join(data_dir, split, "text")
        res = {}
        for tag in ADVERSARIAL_TAGS:
            cer = os.path.join(exp_dir, f"cer_{split}_{tag}.txt")
            with open(cer, "w", encoding="utf-8") as f:
                _tool("compute_wer", ref, _hyp(exp_dir, f"{split}_{tag}"),
                      stdout=f)
            res[tag] = overall_cer(cer)
        for name, a, b in ADVERSARIAL_PAIRS:
            res[name] = compare(ref, _hyp(exp_dir, f"{split}_{a}"),
                                _hyp(exp_dir, f"{split}_{b}"))
        out[split] = res
        print(split, json.dumps(res))
    _dump(out, os.path.join(exp_dir, "results_adversarial.json"))
    return out


def streaming(exp_dir: str, ref: str) -> dict:
    """The streamed drive's CERs (STREAM_TAGS) and STREAM_PAIR's
    comparison, written to exp_dir/results_streaming.json."""
    out = {tag: overall_cer(os.path.join(exp_dir, f"cer_{tag}.txt"))
           for tag in STREAM_TAGS}
    name, a, b = STREAM_PAIR
    out[name] = compare(ref, _hyp(exp_dir, a), _hyp(exp_dir, b))
    print(json.dumps(out))
    _dump(out, os.path.join(exp_dir, "results_streaming.json"))
    return out


def moe(exp_dir: str) -> dict:
    """The MoE drive's CERs (MOE_TAGS, in that order), written to
    exp_dir/results_moe.json."""
    out = collect(exp_dir, MOE_TAGS, os.path.join(exp_dir, MOE))
    print(json.dumps(out))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("exp_dir")
    c.add_argument("out")
    c.add_argument("tags", nargs="+")
    for name in ("significance", "int8", "streaming"):
        s = sub.add_parser(name)
        s.add_argument("exp_dir")
        s.add_argument("ref")
    m = sub.add_parser("moe")
    m.add_argument("exp_dir")
    a = sub.add_parser("adversarial")
    a.add_argument("exp_dir")
    a.add_argument("data_dir")
    args = p.parse_args(argv)
    if args.cmd == "collect":
        print(json.dumps(collect(args.exp_dir, args.tags, args.out)))
    elif args.cmd == "significance":
        significance(args.exp_dir, args.ref)
    elif args.cmd == "int8":
        int8(args.exp_dir, args.ref)
    elif args.cmd == "streaming":
        streaming(args.exp_dir, args.ref)
    elif args.cmd == "moe":
        moe(args.exp_dir)
    else:
        adversarial(args.exp_dir, args.data_dir)


if __name__ == "__main__":
    main()
