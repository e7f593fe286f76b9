"""The port's serving-load bench and its bilingual messages against the JAX
package's (tiny config, CPU):

- tools/bench_serving.py with loadgen's `run_load` and `_tts_once` stubbed:
  JAX's seven scenario lines (and host_dispatch_rtt_ms) in JAX's order with
  JAX's fields (read from JAX's source), each load at JAX's rates,
  concurrencies and windows; `service_throughput_8way` runs for real on a
  tiny engine and answers every request; `--scenarios` runs the named
  lines alone; the parser takes JAX's flags but the XLA-only `--cache_dir`;
- utils/i18n.py: `t()` equals JAX's for every key in both languages, the
  default language and the unknown-key fallback."""

import ast
import pathlib
import re

import pytest

import tests.torch_port_util  # noqa: F401  (one torch thread per test worker)
from flowmirror_hydravox_tpu.utils import i18n as jax_i18n
from flowmirror_hydravox_tpu_torch.tools import bench_serving
from flowmirror_hydravox_tpu_torch.utils import i18n

JAX_BENCH = pathlib.Path(__file__).resolve().parents[1] / "flowmirror_hydravox_tpu" / "tools" / \
    "bench_serving.py"
JAX_ORDER = ["host_dispatch_rtt_ms", "ttft_under_load_http_continuous",
             "staggered_load_continuous", "staggered_capacity_continuous", "ttft_under_load_http",
             "staggered_load_window", "staggered_mode_winner", "service_throughput_8way"]
LOAD_FIELDS = ("mode", "arrival", "rate_rps", "requests", "errors", "rps", "audio_s_per_s",
               "rtf_effective", "latency_p50_ms", "latency_p95_ms", "ttft_p50_ms", "ttft_p95_ms",
               "interchunk_gap_p95_ms", "batched_requests", "continuous_requests",
               "first_errors")


def jax_metric_fields() -> list:
    """(metric-name pattern, field set) of every metric line JAX's
    bench_serving emits under a literal (or f-string) name."""
    out = []
    for node in ast.walk(ast.parse(JAX_BENCH.read_text())):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "emit"
                and isinstance(node.args[0], ast.Dict)):
            continue
        d = node.args[0]
        keys = [k.value for k in d.keys]
        if "metric" not in keys:
            continue
        name = d.values[keys.index("metric")]
        if isinstance(name, ast.Constant):
            pattern = re.escape(name.value)
        elif isinstance(name, ast.JoinedStr):
            pattern = "".join(re.escape(v.value) if isinstance(v, ast.Constant) else r"\w+"
                              for v in name.values)
        else:  # the skipped / error lines, under the section's name
            continue
        out.append((pattern, set(keys)))
    return out


def test_bench_serving_scenarios_in_jax_order(monkeypatch):
    loads, bg = [], []

    def run_load(url, payload, **kw):
        loads.append(kw)
        res = dict.fromkeys(LOAD_FIELDS, 1.0)
        res.update(mode=kw["mode"], requests=3, errors=0, first_errors=None)
        return res

    def tts_once(url, payload, timeout):
        bg.append(url)
        bench_serving.time.sleep(0.05)
        return 0.05, 1.0

    monkeypatch.setattr(bench_serving, "run_load", run_load)
    monkeypatch.setattr(bench_serving, "_tts_once", tts_once)
    engine, frontend = bench_serving.build(tiny=True, device="cpu", max_tokens=32)
    args = bench_serving.parse_args(["--window", "1", "--budget", "900"])
    lines = bench_serving.run(args, engine, frontend, emit=lambda obj: None)

    metrics = [ln for ln in lines if "metric" in ln]
    assert [ln["metric"] for ln in metrics] == JAX_ORDER
    assert not any("error" in ln or ln.get("skipped") for ln in metrics), metrics
    jax_fields = jax_metric_fields()
    assert len(jax_fields) == 7
    for ln in metrics:
        fields = [f for pattern, f in jax_fields if re.fullmatch(pattern, ln["metric"])]
        assert fields == [set(ln)], (ln["metric"], fields)
    assert [ln["section"] for ln in lines if "section" in ln] == [
        "ttft_under_load_continuous", "staggered_load_continuous",
        "staggered_capacity_continuous", "ttft_under_load_window", "staggered_load_window",
        "service_throughput_8way", "bench_serving_total"]
    assert [(kw["mode"], kw["arrival"] if "arrival" in kw else "closed", kw.get("rate"),
             kw["concurrency"], kw["duration"]) for kw in loads] == [
        ("stream", "closed", None, 2, 1.0), ("tts", "poisson", 3.0, 8, 15.0),
        ("tts", "poisson", 8.0, 16, 15.0), ("stream", "closed", None, 2, 1.0),
        ("tts", "poisson", 3.0, 8, 15.0)]
    assert len(set(bg)) == 2  # one server per mode, loaded and warmed through _tts_once
    burst = metrics[-1]
    assert burst["errors"] == 0 and burst["audio_s"] > 0 and burst["batched_requests"] > 0
    assert metrics[0]["value"] > 0

    # a subset: one TTFT line alone, at a longer window
    loads.clear()
    args = bench_serving.parse_args(["--window", "2", "--scenarios", "ttft_under_load_http"])
    lines = bench_serving.run(args, engine, frontend, emit=lambda obj: None)
    assert [ln["metric"] for ln in lines if "metric" in ln] == [
        "host_dispatch_rtt_ms", "ttft_under_load_http"]
    assert [(kw["mode"], kw["duration"]) for kw in loads] == [("stream", 2.0)]
    with pytest.raises(ValueError):
        bench_serving.run(bench_serving.parse_args(["--scenarios", "ttft"]), engine, frontend,
                          emit=lambda obj: None)

    flags = {a for a in re.findall(r'"(--\w+)"', JAX_BENCH.read_text())}
    port = bench_serving.parse_args([])
    assert flags - {"--cache_dir"} <= {"--" + k for k in vars(port)}
    assert (port.budget, port.window, port.device) == (1500.0, 10.0, "cuda")


@pytest.mark.parametrize("lang", ["en", "zh", "fr", None])
def test_i18n_matches_jax(monkeypatch, lang):
    for var in ("HYDRAVOX_LANG", "HYDRAVOX_UI_LANG"):
        monkeypatch.delenv(var, raising=False)
    if lang:
        monkeypatch.setenv("HYDRAVOX_LANG", lang)
    assert i18n.language() == jax_i18n.language() == ("zh" if lang == "zh" else "en")
    assert i18n._TABLE == jax_i18n._TABLE
    kwargs = dict(duration=1.5, tps=2.0, rtf=0.25, error="boom", spk="spk0", speakers="a, b",
                  path="p.npz", tid="t1", stage=3, field="text", host="0.0.0.0", port=8080,
                  secs=2.5, n=700)
    for key in jax_i18n._TABLE:
        assert i18n.t(key, **kwargs) == jax_i18n.t(key, **kwargs), key
        assert i18n.t(key) == jax_i18n.t(key), key  # a missing argument: the raw message
    assert i18n.t("nonexistent_key") == jax_i18n.t("nonexistent_key") == "nonexistent_key"
