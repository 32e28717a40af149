"""Text processing (host): CJK tokenization, punctuation stripping, dict
IO. Port of openeat_tpu/dataset/text.py without BPE, which comes with a
later slice."""

from __future__ import annotations

import re
from string import punctuation as _ascii_punct

CJK_PATTERN = re.compile(r"([一-鿿])")

# Chinese/fullwidth punctuation (zhon.hanzi.punctuation equivalent set)
_CN_PUNCT = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃〈〉《》"
    "「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏﹑﹔·！？｡。")
_EN_PUNCT = _ascii_punct.replace("'", "")  # keep apostrophes (I'M)
_PUNCT_RE = re.compile("[%s]+" % re.escape(_CN_PUNCT + _EN_PUNCT))


def remove_punctuation(text: str) -> str:
    """Strip CN+EN punctuation, keep apostrophes."""
    return _PUNCT_RE.sub("", text).replace("\\", "")


def tokenize(text: str) -> list[str]:
    """CJK characters one by one; other spans kept whole."""
    tokens: list[str] = []
    for span in CJK_PATTERN.split(text.upper()):
        if len(span.strip()) == 0:
            continue
        if "#" in span or CJK_PATTERN.fullmatch(span) is not None:
            tokens.append(span)
        else:
            tokens.append(span.strip())
    return tokens


def text_to_token_ids(text: str, char_dict: dict[str, int],
                      unk: str = "<unk>") -> list[int]:
    """Protect <unk>, strip punctuation, tokenize, map with unk fallback."""
    text = text.replace(unk, "\x00")
    text = remove_punctuation(text)
    text = text.replace("\x00", "#")
    unk_id = char_dict.get(unk, 1)
    return [char_dict.get(t, unk_id) for t in tokenize(text)]


def load_dict(path: str) -> dict[str, int]:
    """Load a `<token> <id>` dict file."""
    d = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                d[parts[0]] = int(parts[1])
    return d


def token_ids_to_text(ids, id2tok: dict[int, str], eos_id: int | None = None,
                      bpe_join: bool = True) -> str:
    """ids -> text; stops at eos; re-joins '▁' pieces with spaces."""
    toks = []
    for i in ids:
        i = int(i)
        if eos_id is not None and i == eos_id:
            break
        toks.append(id2tok.get(i, "<unk>"))
    s = "".join(toks)
    if bpe_join:
        s = s.replace("▁", " ").strip()
    return s
