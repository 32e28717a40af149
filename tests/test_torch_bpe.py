"""The port's BPE tokenizer against the JAX package's.

On a seeded English corpus (pseudo-words from numpy with Zipf
frequencies, as LibriSpeech transcripts are) both trainers learn the
same merges in the same order and the same vocabulary; both encode the
same pieces and ids; a model file written by either package loads in
the other; train_bpe and text2token write the same files and lines as
the JAX CLIs; a sentencepiece `.model` without sentencepiece raises
ImportError in both; the LM's TextDataset tokenizes with a BPE model
as JAX's does. Every comparison is exact.
"""

import json
import string

import numpy as np
import pytest

from openeat_tpu.bin import text2token as jax_text2token
from openeat_tpu.bin import train_bpe as jax_train_bpe_cli
from openeat_tpu.dataset import bpe as jax_bpe
from openeat_tpu.dataset import text as jax_text
from openeat_tpu.dataset.dataset import TextDataset as JaxTextDataset
from openeat_torch.bin import text2token, train_bpe
from openeat_torch.dataset import bpe
from openeat_torch.dataset import text as port_text
from openeat_torch.dataset.dataset import TextDataset


def english_lines(rng: np.random.Generator, n_lines: int,
                  n_words: int = 300, max_words: int = 14) -> list[str]:
    """Transcripts over a lexicon of pseudo-words (2-9 letters, an
    apostrophe now and then) drawn with Zipf frequencies."""
    letters = np.array(list(string.ascii_uppercase))
    lexicon = []
    while len(lexicon) < n_words:
        w = "".join(rng.choice(letters, int(rng.integers(2, 10))))
        if rng.random() < 0.05:
            w = w[:-1] + "'" + w[-1]
        if w not in lexicon:
            lexicon.append(w)
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [" ".join(lexicon[i] for i in rng.choice(
        n_words, int(rng.integers(3, max_words + 1)), p=p))
        for _ in range(n_lines)]


@pytest.fixture(scope="module")
def lines():
    return english_lines(np.random.default_rng(12), 400)


@pytest.mark.parametrize("vocab_size", [80, 300])
def test_merges_and_vocab_equal_jax(lines, vocab_size):
    port = bpe.train_bpe(lines, vocab_size)
    ref = jax_bpe.train_bpe(lines, vocab_size)
    assert port.merges == ref.merges and port.vocab == ref.vocab
    assert len(port.merges) > 0


def test_pieces_and_ids_equal_jax(lines):
    port = bpe.train_bpe(lines, 300)
    ref = jax_bpe.train_bpe(lines, 300)
    vocab = ["<blank>", "<unk>"] + port.vocab + ["<sos/eos>"]
    char_dict = {t: i for i, t in enumerate(vocab)}
    for line in lines[:60] + ["<unk> HELLO, WORLD!", "MIXED 你好 TEXT"]:
        pieces = port_text.tokenize(line, port)
        assert pieces == jax_text.tokenize(line, ref)
        assert port.decode_pieces(pieces) == ref.decode_pieces(pieces)
        assert port_text.text_to_token_ids(line, char_dict, port) \
            == jax_text.text_to_token_ids(line, char_dict, ref)
    ids = port_text.text_to_token_ids(lines[0], char_dict, port)
    id2tok = {i: t for t, i in char_dict.items()}
    assert port_text.token_ids_to_text(ids, id2tok) == lines[0]


def test_model_file_loads_across_packages(lines, tmp_path):
    port = bpe.train_bpe(lines, 120)
    port.save(str(tmp_path / "port.bpe.json"))
    jax_bpe.train_bpe(lines, 120).save(str(tmp_path / "jax.bpe.json"))
    assert (tmp_path / "port.bpe.json").read_bytes() \
        == (tmp_path / "jax.bpe.json").read_bytes()
    assert json.loads((tmp_path / "port.bpe.json").read_text())[
        "format"] == "openeat_tpu_bpe_v1"
    by_jax = jax_bpe.load_bpe(str(tmp_path / "port.bpe.json"))
    by_port = bpe.load_bpe(str(tmp_path / "jax.bpe.json"))
    assert by_jax.merges == by_port.merges == port.merges
    assert by_port.vocab == port.vocab
    assert bpe.load_bpe(None) is None


def test_cli_outputs_equal_jax(lines, tmp_path, capsys):
    text = tmp_path / "text"
    text.write_text("".join(f"utt{i} {line}\n"
                            for i, line in enumerate(lines)),
                    encoding="utf-8")
    path = train_bpe.main(["--input", str(text), "--skip_ncols", "1",
                           "--model_prefix", str(tmp_path / "port"),
                           "--vocab_size", "200"])
    jax_train_bpe_cli.main(["--input", str(text), "--skip_ncols", "1",
                            "--model_prefix", str(tmp_path / "jax"),
                            "--vocab_size", "200"])
    assert path == str(tmp_path / "port.bpe.json")
    for ext in (".bpe.json", ".vocab"):
        assert (tmp_path / f"port{ext}").read_bytes() \
            == (tmp_path / f"jax{ext}").read_bytes()
    capsys.readouterr()
    text2token.main([str(text), "--bpe_model", path])
    got = capsys.readouterr().out
    jax_text2token.main([str(text), "--bpe_model", path])
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == len(lines)
    assert "▁" in got


def test_sentencepiece_model_without_sentencepiece_raises(tmp_path):
    try:
        import sentencepiece  # noqa: F401
        pytest.skip("sentencepiece is installed")
    except ImportError:
        pass
    path = str(tmp_path / "bpe.model")
    for load in (bpe.load_bpe, jax_bpe.load_bpe):
        with pytest.raises(ImportError, match="sentencepiece"):
            load(path)


def test_text_dataset_takes_a_bpe_model(lines, tmp_path):
    model = bpe.train_bpe(lines, 150)
    vocab = ["<blank>", "<unk>"] + model.vocab + ["<sos/eos>"]
    char_dict = {t: i for i, t in enumerate(vocab)}
    path = tmp_path / "lm.txt"
    path.write_text("\n".join(lines[:50]) + "\n", encoding="utf-8")
    got = TextDataset(str(path), char_dict, model, batch_size=8).rows
    want = JaxTextDataset(str(path), char_dict, model, batch_size=8).rows
    assert [r.tolist() for r in got] == [r.tolist() for r in want]
    assert len(got) == 50
