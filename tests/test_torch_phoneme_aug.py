"""Phoneme-substitution augmentation in the port (its own copy of
train/phoneme_aug.py) against the JAX package's, with lexicons written to a
temporary directory and read through HYDRAVOX_CMU_LEXICON /
HYDRAVOX_PINYIN_LEXICON (cmudict, pronouncing and pypinyin are optional):

- `PhonemeAugmenter` gives JAX's output on English, Chinese and mixed texts
  over several seeds, text after text from one seeded augmenter;
- `LLMCollator(phoneme_aug=)` gives JAX's batch, the specials tokenized;
- `train_llm --phoneme_aug` trains on augmented texts.
"""

import os

import numpy as np
import pytest

from flowmirror_hydravox_tpu.frontend.tokenizer import SPECIAL_TOKENS as JAX_SPECIALS
from flowmirror_hydravox_tpu.frontend.tokenizer import get_tokenizer as jax_get_tokenizer
from flowmirror_hydravox_tpu.train import data as jdata
from flowmirror_hydravox_tpu.train import phoneme_aug as jaug
from flowmirror_hydravox_tpu_torch.frontend.tokenizer import SPECIAL_TOKENS, get_tokenizer
from flowmirror_hydravox_tpu_torch.train import data
from flowmirror_hydravox_tpu_torch.train import phoneme_aug as taug
from tests.torch_port_util import seeded_tiny_trees

CMU = {"hello": "HH AH0 L OW1", "world": "W ER1 L D", "speech": "S P IY1 CH",
       "token": "T OW1 K AH0 N", "model": "M AA1 D AH0 L", "don't": "D OW1 N T"}
PINYIN = {"中": "zhong1", "国": "guo2", "好": "hao3", "语": "yu3", "音": "yin1", "女": "nv3",
          "二": "er4", "六": "liu4"}
TEXTS = ["hello world, the speech model reads a token.",
         "中国好语音",
         "hello 中国 speech",
         "我们的模型说女二六",
         "Don't stop the model now.",
         "nothing here matches.",
         "语音 and 音"]


@pytest.fixture
def lexicons(tmp_path, monkeypatch):
    cmu = tmp_path / "cmu.dict"
    cmu.write_text(";;; a cmudict-format lexicon\n" + "".join(
        f"{w.upper()}  {p}\n" for w, p in CMU.items()) + "HELLO(2)  HH EH0 L OW1\n")
    pinyin = tmp_path / "pinyin.txt"
    pinyin.write_text("".join(f"{c} {s}\n" for c, s in PINYIN.items()))
    monkeypatch.setenv("HYDRAVOX_CMU_LEXICON", str(cmu))
    monkeypatch.setenv("HYDRAVOX_PINYIN_LEXICON", str(pinyin))


def test_augmenter_matches_jax_over_texts_and_seeds(lexicons):
    assert SPECIAL_TOKENS == list(JAX_SPECIALS)
    changed = 0
    for seed in range(6):
        got_aug = taug.PhonemeAugmenter(SPECIAL_TOKENS, seed=seed)
        want_aug = jaug.PhonemeAugmenter(JAX_SPECIALS, seed=seed)
        for text in TEXTS * 2:
            got, want = got_aug(text), want_aug(text)
            assert got == want, (seed, text)
            changed += got != text
    assert changed > 40  # the lexicons were read: most texts change
    for syl in ("zhong1", "guo2", "lv4", "er2", "liu2", "a5", "xue2"):
        assert taug.numeric_pinyin_to_tone_final(syl) == jaug.numeric_pinyin_to_tone_final(syl)


def test_llm_collator_with_phoneme_aug_matches_jax(lexicons):
    rng = np.random.default_rng(0)
    rows = [{"text": text, "speech_token": rng.integers(0, 50, 12).tolist()} for text in TEXTS]
    tok, jtok = get_tokenizer(), jax_get_tokenizer()
    got = data.LLMCollator(tok, phoneme_aug=taug.PhonemeAugmenter(SPECIAL_TOKENS, seed=3))(rows)
    want = jdata.LLMCollator(jtok, phoneme_aug=jaug.PhonemeAugmenter(JAX_SPECIALS, seed=3))(rows)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain = data.LLMCollator(tok)(rows)
    assert not np.array_equal(plain["text_token"], got["text_token"])
    assert tok.encode("[HH]")[0] in got["text_token"]


def test_train_llm_runs_with_phoneme_aug(lexicons, tmp_path):
    import datasets

    from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
    from flowmirror_hydravox_tpu_torch.train import checkpoint, train_llm

    tree = dict(seeded_tiny_trees()[0])
    heads = dict(tree["mtp_block"])  # the heads' MLP narrowed: a cheap step
    for name in ("gate_proj_w", "up_proj_w"):
        heads[name] = np.ascontiguousarray(heads[name][:, :, :256])
    heads["down_proj_w"] = np.ascontiguousarray(heads["down_proj_w"][:, :256])
    tree["mtp_block"] = heads
    npz = str(tmp_path / "llm.npz")
    checkpoint.save_params_npz(npz, from_numpy_tree(tree, "cpu"))
    rng = np.random.default_rng(1)
    ds = str(tmp_path / "ds")
    datasets.Dataset.from_list([{"text": TEXTS[i % len(TEXTS)],
                                 "speech_token": rng.integers(0, 50, 10).tolist()}
                                for i in range(8)]).save_to_disk(ds)
    out = str(tmp_path / "run")
    res = train_llm.main(["--train_data", ds, "--output_dir", out, "--tiny", "--device", "cpu",
                          "--batch_size", "4", "--max_steps", "1", "--save_steps", "100",
                          "--model_ckpt", npz, "--phoneme_aug"])
    assert res["step"] == 1 and np.isfinite(res["metrics"]["loss"])
    assert os.path.exists(os.path.join(out, "step_1.pt"))
