"""The port's training data pipeline, checkpoints and trainer CLIs (tiny
config, CPU):

- `LLMCollator`, `FlowCollator`, `dynamic_batch_iterator` (budget and
  power-of-two padding), `batch_iterator`, `static_batch_iterable` and
  `iterate_rows` give the JAX package's outputs exactly; so do
  `make_batch_source` over an HF dataset dir (with a validation split) and
  a parquet shard list;
- a port-trained npz (one step from the seeded tiny trees) loads in the JAX
  `load_params_npz` bit for bit and serves through the launcher's
  `load_models` in the port's `Engine`; `average_checkpoints` equals JAX's,
  `graft_mtp_weights` keeps every other leaf;
- `train_llm` runs 3 steps on a tiny saved HF dataset from a reference-
  layout llm.pt (`--model_ckpt`; eval on the validation split); its saved
  train state restores into a fresh state (params, both moments, count),
  and `--resume` continues the step count to 5;
- `train_flow` runs from an npz (`--model_ckpt`; rows with a mel and rows
  with audio, `--grad_accum 2`);
- `tools/bench_train.py --tiny --device cpu` runs the LLM, flow and DPO
  points and the LLM under `--accum 2`, and prints no device metric;
- the multi-device flags (of `train_llm`, `train_flow` and `train_dpo`)
  exit non-zero naming the slice that ports them, `--accum` with another
  point than the LLM's is refused; every entry point defaults to cuda and
  raises without a GPU (train_hift's refusals are in
  tests/test_torch_train_hift.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.frontend.tokenizer import ByteTokenizer as JaxByteTokenizer
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.train import data as jdata
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.convert import torch_import
from flowmirror_hydravox_tpu_torch.frontend.tokenizer import ByteTokenizer
from flowmirror_hydravox_tpu_torch.noise import TorchNoise
from flowmirror_hydravox_tpu_torch.params import flatten_params, from_numpy_tree, unflatten_params
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
from flowmirror_hydravox_tpu_torch.tools import bench_train
from flowmirror_hydravox_tpu_torch.train import checkpoint as ckpt
from flowmirror_hydravox_tpu_torch.train import data, steps, train_dpo, train_flow, train_llm
from tests.torch_port_util import n, seeded_tiny_trees

CFG = tiny_config()


def _llm_rows(n_rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"text": f"Sample {i}: the tiny trainer reads {i * 7} words on 5/1.",
             "speech_token": rng.integers(0, 50, int(rng.integers(8, 24))).tolist()}
            for i in range(n_rows)]


def _flow_rows(n_rows=8, seed=0, audio_every=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        toks = int(rng.integers(6, 12))
        row = {"speech_token": rng.integers(0, 50, toks).tolist(),
               "mel": rng.standard_normal((2 * toks + int(rng.integers(0, 3)), 80)).astype(
                   np.float32).tolist(),
               "embedding": rng.standard_normal(192).astype(np.float32).tolist()}
        if audio_every and i % audio_every == 0:
            row["mel"] = None
            row["audio"] = {"array": (0.1 * rng.standard_normal(24000 * toks // 25)).tolist(),
                            "sampling_rate": 24000}
        rows.append(row)
    return rows


def _same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _save(rows, path):
    import datasets

    datasets.Dataset.from_list(rows).save_to_disk(path)
    return path


def test_collators_and_iterators_match_jax():
    rows = _llm_rows()
    tcoll = data.LLMCollator(ByteTokenizer(), text_buckets=(32, 64, 128))
    jcoll = jdata.LLMCollator(JaxByteTokenizer(), text_buckets=(32, 64, 128))
    _same(tcoll(rows[:5]), jcoll(rows[:5]), "LLMCollator")
    for kw in (dict(epochs=1, sort_window=8), dict(epochs=2, shuffle=False, drop_last=False)):
        got = list(data.batch_iterator(rows, tcoll, 4, **kw))
        want = list(jdata.batch_iterator(rows, jcoll, 4, **kw))
        assert len(got) == len(want) > 0, kw
        for g, w in zip(got, want):
            _same(g, w, f"batch_iterator {kw}")
    for g, w in zip(data.static_batch_iterable(rows, tcoll, 5, drop_last=False),
                    jdata.static_batch_iterable(rows, jcoll, 5, drop_last=False)):
        _same(g, w, "static_batch_iterable")
    assert ([r["text"] for r in data.iterate_rows(rows, seed=3, epochs=2)]
            == [r["text"] for r in jdata.iterate_rows(rows, seed=3, epochs=2)])
    frows = _flow_rows()
    tfc, jfc = data.FlowCollator(token_buckets=(16, 32)), jdata.FlowCollator(token_buckets=(16, 32))
    _same(tfc(frows[:3]), jfc(frows[:3]), "FlowCollator")
    for kw in (dict(max_frames_in_batch=60), dict(max_frames_in_batch=100, min_batch_multiple=4),
               dict(max_frames_in_batch=40, pad_batch_pow2=False)):
        got = list(data.dynamic_batch_iterator(frows, tfc, **kw))
        want = list(jdata.dynamic_batch_iterator(frows, jfc, **kw))
        assert len(got) == len(want) > 1, kw
        for g, w in zip(got, want):
            _same(g, w, f"dynamic_batch_iterator {kw}")


def test_batch_sources_match_jax(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = _llm_rows(12)
    hf = _save(rows, str(tmp_path / "hf"))
    shard = str(tmp_path / "shard.parquet")
    pq.write_table(pa.Table.from_pylist(rows[:6]), shard)
    listing = tmp_path / "shards.txt"
    listing.write_text(f"{shard}\n{_save(rows[6:], str(tmp_path / 'hf2'))}\n")
    tcoll = data.LLMCollator(ByteTokenizer(), text_buckets=(64,))
    jcoll = jdata.LLMCollator(JaxByteTokenizer(), text_buckets=(64,))
    for kw in (dict(train_data=hf, val_split=0.25), dict(train_data=hf, batch_type="dynamic",
                                                          max_frames_in_batch=80),
               dict(shard_list=str(listing)), dict(shard_list=str(listing), batch_type="dynamic",
                                                   max_frames_in_batch=80)):
        (got, got_val), (want, want_val) = (
            mod.make_batch_source(coll, 4, epochs=1, **kw)
            for mod, coll in ((data, tcoll), (jdata, jcoll)))
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0, kw
        for g, w in zip(got, want):
            _same(g, w, f"make_batch_source {kw}")
        assert (got_val is None) == (want_val is None)
        if got_val is not None:
            assert [r["text"] for r in got_val] == [r["text"] for r in want_val]


def _trained_trees():
    """The seeded tiny LLM and flow trees (f32) after one train step each."""
    llm, flow, _ = (from_numpy_tree(tree, "cpu") for tree in seeded_tiny_trees())
    opt = steps.Optimizer(steps.OptimConfig(learning_rate=1e-3, warmup_steps=1))
    coll = data.LLMCollator(ByteTokenizer(), text_buckets=(64,), speech_buckets=(32,))
    state, _ = steps.llm_train_step(steps.init_state(llm, opt),
                                    steps.batch_to(coll(_llm_rows(4)), "cpu"), CFG.llm, opt)
    fstate, _ = steps.flow_train_step(
        steps.init_state(flow, opt), steps.batch_to(data.FlowCollator((16,))(_flow_rows(4)), "cpu"),
        TorchNoise(torch.Generator().manual_seed(0)), CFG.flow, opt)
    return state.params, fstate.params


def test_trained_npz_loads_in_jax_and_serves_in_the_engine(tmp_path):
    llm, flow = _trained_trees()
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    for name, tree in (("llm", llm), ("flow", flow)):
        path = str(model_dir / f"{name}.npz")
        ckpt.save_params_npz(path, tree)
        # shapes and dtypes only: a zeros leaf would compile one program per shape
        template = jax.tree.map(lambda p: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32),
                                tree)
        loaded = flatten_params(jax.tree.map(np.asarray, jckpt.load_params_npz(path, template)))
        for k, p in flatten_params(tree).items():
            np.testing.assert_array_equal(loaded[k], n(p), err_msg=f"{name}: {k}")
        back = ckpt.load_params_npz(path, jax.tree.map(lambda p: p.detach().to(torch.bfloat16),
                                                       tree))
        assert back["rand_noise" if name == "flow" else "llm_decoder"].dtype == torch.bfloat16

    # averaging and grafting, against the JAX tools
    first = str(tmp_path / "first.npz")
    ckpt.save_params_npz(first, from_numpy_tree(seeded_tiny_trees()[0], "cpu"))
    paths = [first, str(model_dir / "llm.npz")]
    want = jckpt.average_checkpoints(paths, jax.tree.map(jnp.asarray, seeded_tiny_trees()[0]))
    got = ckpt.average_checkpoints(paths, from_numpy_tree(seeded_tiny_trees()[0], "cpu"))
    for k, w in flatten_params(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(n(flatten_params(got)[k]), w, rtol=1e-6, atol=1e-7, err_msg=k)
    stripped = {k: v for k, v in llm.items() if k != "mtp_block"}
    grafted = ckpt.graft_mtp_weights(stripped, CFG.llm, torch.Generator().manual_seed(7),
                                     torch.float32)
    assert grafted["backbone"] is stripped["backbone"]
    assert grafted["mtp_block"]["gate_proj_w"].shape[0] == CFG.llm.head_num

    cfg, trees = launcher.load_models(True, str(model_dir), ByteTokenizer(), torch.device("cpu"),
                                      torch.float32)
    for k, p in flatten_params(trees["llm"]).items():
        assert torch.equal(p, flatten_params(llm)[k].detach()), k
    engine = Engine(cfg, trees["llm"], trees["flow"], trees["hift"], max_tokens=32, device="cpu")
    res = engine.synthesize((np.arange(9, dtype=np.int32) * 7) % 256, 9, inference_head_num=2,
                            noise=engine.noise_for(3))
    assert len(res.speech_tokens) > 0 and res.audio.size > 0 and np.isfinite(res.audio).all()


def _llm_args(ds, out, *extra):
    return ["--train_data", ds, "--output_dir", out, "--tiny", "--device", "cpu",
            "--batch_size", "4", "--logging_steps", "1", "--save_steps", "100",
            "--learning_rate", "1e-3", "--warmup_steps", "1", *extra]


def _near(saved, tree, tol):
    """Every leaf of the saved train state within `tol` of `tree`'s."""
    for k, p in flatten_params(tree).items():
        np.testing.assert_allclose(saved["params"][k].float().numpy(), p, atol=tol, err_msg=k)


def test_train_llm_cli_then_resume(tmp_path):
    ds = _save(_llm_rows(), str(tmp_path / "llm_ds"))
    out = str(tmp_path / "run")
    # start from the reference's llm.pt layout (--model_ckpt through the converter)
    start = seeded_tiny_trees()[0]
    pt = str(tmp_path / "llm.pt")
    torch.save(torch_import.reference_state_dict("llm", from_numpy_tree(start, "cpu"), CFG), pt)
    first = train_llm.main(_llm_args(ds, out, "--max_steps", "3", "--auto_val_split",
                                     "--val_split_ratio", "0.25", "--eval_steps", "2",
                                     "--model_ckpt", pt))
    assert first["step"] == 3 and np.isfinite(first["metrics"]["loss"])
    assert os.path.exists(os.path.join(out, "step_3.pt"))
    # three steps of about lr each from the loaded weights, and a bf16 rounding
    # (the seed-42 init differs from them by ~0.4 in the x20 decoder)
    saved = torch.load(os.path.join(out, "step_3.pt"), weights_only=True)
    _near(saved, start, 0.04)
    # the restore fills a fresh state's tensors with every saved leaf, both
    # moments and the count
    zeros = unflatten_params({k: torch.zeros_like(p) for k, p in saved["params"].items()})
    fresh = steps.init_state(zeros, steps.Optimizer(steps.OptimConfig()))
    restored = ckpt.restore_train_state(out, fresh)
    assert restored.step == 3 and restored.opt_state["count"] == 3
    for k, p in steps.tree_leaves(restored.params):
        assert torch.equal(p, saved["params"][k]), k
    for name in ("mu", "nu"):
        assert restored.opt_state[name].keys() == saved["opt_state"][name].keys()
        for k, t in restored.opt_state[name].items():
            assert torch.equal(t, saved["opt_state"][name][k]), (name, k)
        assert any(t.abs().max() > 0 for t in restored.opt_state[name].values()), name
    second = train_llm.main(_llm_args(ds, out, "--max_steps", "5", "--resume", out))
    assert second["step"] == 5 and np.isfinite(second["metrics"]["loss"])
    state = torch.load(os.path.join(out, "step_5.pt"), weights_only=True)
    assert state["step"] == 5 and state["opt_state"]["count"] == 5
    assert state["params"]["llm_decoder"].dtype == torch.bfloat16  # bf16 as in JAX


def test_train_flow_cli_runs(tmp_path):
    ds = _save(_flow_rows(audio_every=3), str(tmp_path / "flow_ds"))
    start = seeded_tiny_trees()[1]
    npz = str(tmp_path / "flow.npz")
    ckpt.save_params_npz(npz, from_numpy_tree(start, "cpu"))
    res = train_flow.main(["--train_data", ds, "--output_dir", str(tmp_path / "run"), "--tiny",
                           "--device", "cpu", "--batch_size", "4", "--max_steps", "2",
                           "--logging_steps", "1", "--grad_accum", "2", "--warmup_steps", "1",
                           "--model_ckpt", npz])
    assert res["step"] == 2 and np.isfinite(res["metrics"]["loss"])
    assert np.isfinite(res["metrics"]["grad_norm"])
    _near(torch.load(str(tmp_path / "run" / "step_2.pt"), weights_only=True), start, 0.03)


def test_bench_train_smoke_on_cpu(capsys):
    names = []
    for args in (["--which", "llm"], ["--which", "flow"], ["--which", "dpo"],
                 ["--which", "llm", "--accum", "2"]):
        (line,) = bench_train.main([*args, "--tiny", "--device", "cpu", "--steps", "1"])
        assert line["device"] == "cpu" and line["step_ms"] > 0 and line["matmul_params"] > 0
        assert not {"mfu", "peak_gb", "card"} & set(line), line
        names.append(line["metric"])
    assert names[2:] == ["train_step_dpo", "train_step_llm_accum2"], names
    assert capsys.readouterr().out.count("\n") == 4


def test_unported_flags_exit_nonzero_and_cuda_is_the_default(tmp_path, capsys):
    ds = str(tmp_path / "missing")
    refused = [(train_llm, flag) for flag in (
        ["--tensor_parallel", "2"], ["--pipeline_parallel", "2"], ["--pp_microbatches", "2"],
        ["--fsdp"], ["--shard_optimizer"], ["--multihost"])]
    refused += [(cli, flag) for cli in (train_flow, train_dpo) for flag in (
        ["--tensor_parallel", "2"], ["--fsdp"], ["--shard_optimizer"], ["--multihost"])]
    for cli, flag in refused:
        with pytest.raises(SystemExit) as exc:
            cli.main(["--train_data", ds, "--output_dir", str(tmp_path), *flag])
        assert exc.value.code != 0, flag
        err = capsys.readouterr().err
        assert "not ported yet" in err and "slice" in err, (flag, err)
    for which in ("flow", "dpo", "gan"):
        with pytest.raises(SystemExit) as exc:
            bench_train.main(["--which", which, "--accum", "2", "--device", "cpu"])
        assert exc.value.code != 0 and "--accum" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    for run in (lambda: train_llm.main(["--train_data", ds, "--output_dir", str(tmp_path)]),
                lambda: train_flow.main(["--train_data", ds, "--output_dir", str(tmp_path)]),
                lambda: train_dpo.main(["--train_data", ds, "--output_dir", str(tmp_path)]),
                lambda: bench_train.main(["--which", "llm"]),
                lambda: bench_train.main(["--which", "dpo"]),
                lambda: bench_train.main(["--which", "gan"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            run()
