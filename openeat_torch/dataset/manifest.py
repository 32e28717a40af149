"""format.data manifest parsing (host).
Port of openeat_tpu/dataset/manifest.py for wav entries.

Each line is tab-separated `utt:<id>  feat:<path>  feat_shape:<dur_s>
text:<...>` (or the 7-field variant with a `tokenid:` column); a wav
path may carry `path,start,end` segment bounds.
"""

from __future__ import annotations

import codecs
from dataclasses import dataclass
from typing import Optional

from openeat_torch.dataset.text import text_to_token_ids


@dataclass
class Utterance:
    key: str
    path: str              # wav path, optionally 'path,start_s,end_s'
    num_frames: float      # 10 ms frames, estimated from the duration
    token_ids: list[int]


def parse_manifest(data_file: str, char_dict: dict[str, int],
                   max_length: float = 10240, min_length: float = 0,
                   token_max_length: int = 200, token_min_length: int = 0,
                   sort: bool = True) -> list[Utterance]:
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
                                              char_dict)
            else:
                token_ids = [int(t) for t in arr[5].split(":", 1)[1].split()]
            num_frames = float(arr[2].split(":", 1)[1]) * 1000.0 / 10.0
            if not (min_length < num_frames < max_length):
                continue
            if not (token_min_length < len(token_ids) < token_max_length):
                continue
            utts.append(Utterance(key, path, num_frames, token_ids))
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
