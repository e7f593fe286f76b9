"""The port's Frontend against the JAX package's on the CPU: every frontend_*
feature dict, and the speaker registry (add, remove, mean embedding, npz
round trip in both directions, a reference-style .pt, a dataset on disk).

Both frontends run the committed extractor checkpoints with their sidecar
configs (the JAX one is handed the same trees, so that it skips its random
init template). Inputs are seeded numpy prompts: 1.5 s at 16 kHz and, for
the voice-conversion source, 1 s at 24 kHz, so both resampling directions
run. Tolerances: token arrays exact; prompt mels within 1e-5 absolute (the
log-mel's); embeddings within 1e-5 absolute (values ~0.06)."""

import jax
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.frontend import speech_tokenizer as jst
from flowmirror_hydravox_tpu.frontend.frontend import Frontend as JaxFrontend
from flowmirror_hydravox_tpu.train.checkpoint import load_params_npz as jax_load_npz
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.frontend.frontend import (ASSET_DIR, INSTRUCT_PROMPTS,
                                                             Frontend, SpeakerInfo)
from tests.test_torch_speech_tokenizer import voiced
from tests.torch_port_util import to_numpy_tree

ATOL = 1e-5
PROMPT = voiced(16000, 1.5, 10)
SOURCE = voiced(24000, 1.0, 11)
PROMPT_TEXT = "This is the prompt speaker talking."
TTS_TEXT = "Clone this voice for a new sentence."


def _jax_frontend(port: Frontend) -> JaxFrontend:
    """The JAX Frontend on the committed checkpoints and sidecar configs."""
    st_cfg = jst.SpeechTokenizerConfig(**vars(port.st_cfg))
    spk_cfg = jst.SpeakerEncoderConfig(**vars(port.spk_cfg))
    trees = {}
    for name, cfg, init in (("tokenizer", st_cfg, jst.init_tokenizer_params),
                            ("speaker", spk_cfg, jst.init_speaker_params)):
        template = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
        trees[name] = jax_load_npz(f"{ASSET_DIR}/{name}.npz", template)
    fe = JaxFrontend(jax_tiny_config(), tokenizer_params=trees["tokenizer"],
                     speaker_params=trees["speaker"])
    fe.st_cfg, fe.spk_cfg = st_cfg, spk_cfg  # read when its jitted extractors trace
    return fe


@pytest.fixture(scope="module")
def frontends():
    port = Frontend(tiny_config(), device="cpu")
    ref = _jax_frontend(port)
    for fe in (port, ref):
        fe.add_speaker_from_audio("cloned", PROMPT, 16000, prompt_text=PROMPT_TEXT)
        fe.add_speaker("plain", SpeakerInfo(embedding=np.linspace(-1, 1, 192, dtype=np.float32)))
    return port, ref


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


MODES = {
    "zero_shot": lambda fe: fe.frontend_zero_shot(TTS_TEXT, PROMPT_TEXT, PROMPT, 16000),
    "cross_lingual": lambda fe: fe.frontend_cross_lingual(TTS_TEXT, PROMPT, 16000),
    "instruct2": lambda fe: fe.frontend_instruct2(TTS_TEXT, INSTRUCT_PROMPTS[18], PROMPT, 16000),
    "instruct": lambda fe: fe.frontend_instruct(TTS_TEXT, "plain", INSTRUCT_PROMPTS[0]),
    "vc": lambda fe: fe.frontend_vc(SOURCE, 24000, PROMPT, 16000),
    "sft": lambda fe: fe.frontend_sft(TTS_TEXT, "cloned"),
    "zero_shot_registered": lambda fe: fe.frontend_zero_shot_registered(TTS_TEXT, "cloned"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_frontend_modes_match_jax(frontends, mode):
    port, ref = frontends
    got, want = MODES[mode](port), MODES[mode](ref)
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], int):
            assert got[key] == want[key], key
        else:
            _assert_same(got[key], want[key])
    if "prompt_mel" in want and want["prompt_mel"] is not None:
        assert len(want["prompt_mel"]) == 2 * len(want["prompt_speech_tokens"]) > 0


def test_registry_add_remove_and_mean(frontends):
    port, ref = frontends
    assert port.available_speakers() == ref.available_speakers() == ["cloned", "plain"]
    for field in ("embedding", "prompt_text", "prompt_speech_tokens", "prompt_mel"):
        _assert_same(getattr(port.spk2info["cloned"], field),
                     getattr(ref.spk2info["cloned"], field))
    _assert_same(port.compute_mean_embedding([PROMPT, PROMPT[:8000]], 16000),
                 ref.compute_mean_embedding([PROMPT, PROMPT[:8000]], 16000))
    for fe in (port, ref):
        fe.add_speaker("gone", SpeakerInfo(embedding=np.zeros(192, np.float32)))
        assert fe.remove_speaker("gone") and not fe.remove_speaker("gone")


def test_spk2info_npz_round_trip(frontends, tmp_path):
    """The port's save loads in both packages, and the JAX save in the port,
    to the same registry (prompt text is not saved, in either)."""
    port, ref = frontends
    port.save_spk2info(str(tmp_path / "port.npz"))
    ref.save_spk2info(str(tmp_path / "ref.npz"))
    loaded = []
    for path in ("port.npz", "ref.npz"):
        fresh = Frontend(tiny_config(), tokenizer=port.tokenizer, device="cpu")
        fresh.load_spk2info_npz(str(tmp_path / path))
        loaded.append(fresh)
    ref_fresh = _jax_frontend(port)
    ref_fresh.load_spk2info_npz(str(tmp_path / "port.npz"))
    for fe in loaded:
        assert fe.available_speakers() == ref_fresh.available_speakers() == ["cloned", "plain"]
        for spk in ("cloned", "plain"):
            for field in ("embedding", "prompt_text", "prompt_speech_tokens", "prompt_mel"):
                _assert_same(getattr(fe.spk2info[spk], field),
                             getattr(ref_fresh.spk2info[spk], field))


def test_load_spk2info_pt(frontends, tmp_path):
    """A reference-style spk2info.pt written with torch.save: `llm_embedding`
    tensors, or `embedding` arrays, cut to 192 values."""
    port, ref = frontends
    rng = np.random.default_rng(5)
    torch.save({"alice": {"llm_embedding": torch.from_numpy(rng.standard_normal((1, 192)))},
                "bob": {"embedding": rng.standard_normal(200).astype(np.float32)}},
               tmp_path / "spk2info.pt")
    port.load_spk2info(str(tmp_path / "spk2info.pt"))
    ref.load_spk2info(str(tmp_path / "spk2info.pt"))
    for spk in ("alice", "bob"):
        _assert_same(port.spk2info[spk].embedding, ref.spk2info[spk].embedding)
        assert port.spk2info[spk].embedding.shape == (192,)
        port.remove_speaker(spk)
        ref.remove_speaker(spk)


@pytest.mark.parametrize("column", ["embedding", "audio"])
def test_add_speaker_from_dataset(frontends, tmp_path, column):
    """Mean-embedding enrolment over a dataset on disk, from a precomputed
    'embedding' column or from 'audio' rows."""
    from datasets import Dataset

    port, ref = frontends
    if column == "embedding":
        rows = {"embedding": [np.full(192, i, np.float32).tolist() for i in range(3)]}
    else:
        rows = {"audio": [{"array": voiced(16000, 0.6, 20 + i).tolist(), "sampling_rate": 16000}
                          for i in range(2)]}
    Dataset.from_dict(rows).save_to_disk(str(tmp_path / "ds"))
    for fe in (port, ref):
        assert fe.add_speaker_from_dataset("enrolled", str(tmp_path / "ds"),
                                           prompt_text="hi") == len(rows[column])
    for field in ("embedding", "prompt_text"):
        _assert_same(getattr(port.spk2info["enrolled"], field),
                     getattr(ref.spk2info["enrolled"], field))
    for fe in (port, ref):
        fe.remove_speaker("enrolled")


def test_extractor_weights_resolve_or_raise(frontends, tmp_path, monkeypatch):
    """Explicit trees, then HYDRAVOX_*_NPZ, then the committed checkpoints
    (frontend.py:60-130); where the JAX frontend would fall back to a random
    init, the port raises."""
    from flowmirror_hydravox_tpu_torch.frontend import frontend as fe_mod
    from flowmirror_hydravox_tpu_torch.params import flatten_params

    port, _ = frontends
    spk = {k: v.numpy() * 2 for k, v in flatten_params(port.speaker_params).items()}
    np.savez(tmp_path / "speaker.npz", **spk)
    (tmp_path / "speaker.json").write_text(open(f"{ASSET_DIR}/speaker.json").read())
    monkeypatch.setenv("HYDRAVOX_SPEAKER_NPZ", str(tmp_path / "speaker.npz"))
    from_env = Frontend(tiny_config(), tokenizer=port.tokenizer, device="cpu")
    for key, val in flatten_params(from_env.speaker_params).items():
        np.testing.assert_array_equal(val.numpy(), spk[key])
    explicit = Frontend(tiny_config(), tokenizer=port.tokenizer, device="cpu",
                        speaker_params=to_numpy_tree(port.speaker_params))
    _assert_same(explicit.extract_spk_embedding(PROMPT, 16000),
                 port.extract_spk_embedding(PROMPT, 16000))
    monkeypatch.delenv("HYDRAVOX_SPEAKER_NPZ")
    monkeypatch.setattr(fe_mod, "ASSET_DIR", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        Frontend(tiny_config(), tokenizer=port.tokenizer, device="cpu")
    np.savez(tmp_path / "bad.npz", **{k: v for k, v in spk.items() if k != "proj"})
    monkeypatch.setenv("HYDRAVOX_SPEAKER_NPZ", str(tmp_path / "bad.npz"))
    with pytest.raises(KeyError, match="proj"):
        Frontend(tiny_config(), tokenizer=port.tokenizer, device="cpu",
                 tokenizer_params=to_numpy_tree(port.tokenizer_params))
