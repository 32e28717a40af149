"""format.data manifest parsing (host).
Port of openeat_tpu/dataset/manifest.py.

Each line is tab-separated `utt:<id>  feat:<path>  feat_shape:<shape>
text:<...>` (or the 7-field variant with a `tokenid:` column). For wav
input (data_type "wav") the shape is the duration in seconds and the
path may carry `path,start,end` segment bounds; for precomputed
features (data_type "feat": a kaldi `ark:offset`) it is `frames,dim`.
Text is tokenized with the dict and an optional BPE model. With
speed_perturb each kept wav utterance becomes one entry per speed of
np.arange(*speeds) (the JAX expression: (0.9, 1.1, 0.1) gives 0.9, 1.0
and 1.1, by float rounding), its frame count num_frames / speed.
"""

from __future__ import annotations

import codecs
from dataclasses import dataclass
from typing import Optional

import numpy as np

from openeat_torch.dataset.text import text_to_token_ids


@dataclass
class Utterance:
    key: str
    path: str              # wav path ('path,start_s,end_s') or 'ark:offset'
    num_frames: float      # 10 ms frames (estimated from a wav's duration)
    token_ids: list[int]
    speed: float = 1.0     # the offline speed perturbation's speed
    feat_dim: int = 0      # > 0 for a precomputed-feature entry


def parse_manifest(data_file: str, char_dict: dict[str, int], bpe=None,
                   max_length: float = 10240, min_length: float = 0,
                   token_max_length: int = 200, token_min_length: int = 0,
                   speed_perturb: bool = False, speeds=(0.9, 1.1, 0.1),
                   data_type: str = "wav",
                   sort: bool = True) -> list[Utterance]:
    speed_list = ([float(s) for s in np.arange(*speeds)] if speed_perturb
                  else [1.0])
    utts: list[Utterance] = []
    with codecs.open(data_file, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split("\t")
            if len(arr) not in (4, 7):
                continue
            key = arr[0].split(":", 1)[1]
            path = arr[1].split(":", 1)[1]
            if len(arr) == 4:
                token_ids = text_to_token_ids(arr[3].split(":", 1)[1],
                                              char_dict, bpe)
            else:
                token_ids = [int(t) for t in arr[5].split(":", 1)[1].split()]
            shape = arr[2].split(":", 1)[1]
            if data_type == "wav":
                num_frames, feat_dim = float(shape) * 1000.0 / 10.0, 0
            else:
                frames, dim = shape.split(",")
                num_frames, feat_dim = int(frames.strip()), int(dim.strip())
            if not (min_length < num_frames < max_length):
                continue
            if not (token_min_length < len(token_ids) < token_max_length):
                continue
            # speed perturbation stretches a waveform, not its features
            utts.extend(Utterance(key, path, num_frames / speed
                                  if data_type == "wav" else num_frames,
                                  token_ids, speed, feat_dim)
                        for speed in speed_list)
    if sort:
        utts.sort(key=lambda u: u.num_frames)
    return utts


def parse_wav_entry(path: str
                    ) -> tuple[str, Optional[float], Optional[float]]:
    """'file.wav' or 'file.wav,start_s,end_s'."""
    parts = path.split(",")
    if len(parts) == 3:
        return parts[0], float(parts[1]), float(parts[2])
    return parts[0], None, None
