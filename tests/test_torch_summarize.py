"""The port's summarize_experiments against scripts/summarize_experiments.py
on the same result JSONs (the JAX package's committed ones, copied into two
temporary roots: the script reads its working directory, the port its
--output-root). Every section but the header and the performance section
prints the same text; the port's header names the card from nvidia-smi (or
says there is none) and no TPU; its performance section reads only the
card's artifacts under the root (the benches' and quant_accuracy's), names
the device beside their numbers and opens no *_v5e* file, though one is
there."""

import builtins
import json
import shutil
import sys

import pytest
from test_torch_experiments import ROOT

import scripts.summarize_experiments as jax_summarize
from lmsu_tpu_torch import summarize_experiments as summarize

RESULTS = ("augment_results.json", "best_overall_results.json", "capacity_gap_results.json",
           "ema_results.json", "fusion_ablation_hard_seeded.json",
           "fusion_gated_sum_results.json", "kd_cache_equiv.json", "kd_comparison_results.json",
           "kd_compression_results.json", "kd_compression_s1.json", "kd_crossarch_best.json",
           "kd_crossarch_results.json", "kd_ensemble_results.json", "kd_sweep_results.json",
           "kd_sweep_s1.json", "kd_sweep_s2.json", "kd_variants_results.json",
           "pp_ablation_seeded.json", "ta_chain_results.json", "teacher_scaling_results.json",
           "teacher_scaling_s1.json", "teacher_scaling_s2.json",
           "docs/weighted_gate_analysis.json")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# The card's artifacts in the benches' schemas, small.
ARTIFACTS = {
    summarize.SERVING_BENCH: {
        "metric": "serving_throughput_rps", "value": 100.0, "unit": "req/s", "device": CARD,
        "detail": {"batch_size": 8, "scatter_impl": "sorted_pallas", "dtype": "bfloat16",
                   "levels": [{"concurrency": 8, "throughput_rps": 100.0,
                               "latency_ms": {"p50": 5.0, "p95": 7.5, "p99": 9.0}}],
                   "saturation": {"duration_s": 2.0, "throughput_rps": 300.0,
                                  "occupancy": 0.99, "shed": 3,
                                  "e2e_latency_ms": {"p50": 40.0}},
                   "null_backend": {"batch_ms": 1.7, "throughput_rps": 900.0,
                                    "occupancy": 1.0}}},
    summarize.FROZEN_BENCH: {"device": CARD, "dtype": "bfloat16", "iters": 20,
                             "rows": [{"batch": 8, "runtime_ms": 1.2, "frozen_ms": 1.0,
                                       "one_forward_ms": 1.1}]},
    summarize.DRESS_REHEARSAL: {"device": CARD, "frames": 96, "frame_source": "numpy",
                                "scatter_impl": "sorted_pallas",
                                "modes": {"packed": [{"epoch": 1, "wall_s": 2.0,
                                                      "frames_per_sec": 38.0,
                                                      "stall_frac": 0.02}]}},
    summarize.QUANT_ACCURACY: {"device": CARD, "model": "weighted/128 (spatial)",
                               "benchmark": "synthetic_hard", "fp32": {"miou": 0.81},
                               "int8": {"miou": 0.8}, "miou_delta": -0.01,
                               "argmax_agreement": 0.998, "calib_batches": 1},
}


def sections(text):
    """{heading: section text} of a report (the header under "")."""
    out, head = {}, ""
    for line in text.splitlines():
        if line.startswith("## "):
            head = line
        out[head] = out.get(head, "") + line + "\n"
    return out


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("summarize")
    for side in ("jax", "port"):
        for name in RESULTS:
            (tmp / side / name).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(ROOT / name, tmp / side / name)
    for name, obj in ARTIFACTS.items():
        (tmp / "port" / name).write_text(json.dumps(obj))
    # A TPU artifact the script's performance section would read: the port's
    # must not open it.
    shutil.copy(ROOT / "docs" / "serving_bench_v5e.json", tmp / "port" / "docs")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp / "jax")
        written = []
        mp.setattr(sys, "stdout", _Capture(written))
        jax_summarize.main(["--stdout"])
    jax_text = "".join(written)

    opened = []
    real_open = builtins.open

    def recording_open(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builtins, "open", recording_open)
        port_text = summarize.report(str(tmp / "port"), card=None)
    return jax_text, port_text, opened, tmp


class _Capture:
    def __init__(self, sink):
        self.sink = sink

    def write(self, s):
        self.sink.append(s)

    def flush(self):
        pass


def test_every_section_but_header_and_perf_prints_the_scripts_text(reports):
    jax_text, port_text, _, _ = reports
    jax_s, port_s = sections(jax_text), sections(port_text)
    perf_jax = [h for h in jax_s if h.startswith("## Performance")]
    perf_port = [h for h in port_s if h.startswith("## Performance")]
    assert len(perf_jax) == len(perf_port) == 1
    shared = [h for h in jax_s if h and h not in perf_jax]
    assert len(shared) == 14  # every section of the script reads its JSONs here
    assert [h for h in port_s if h and h not in perf_port] == shared
    for h in shared:
        assert port_s[h] == jax_s[h], h


def test_header_and_perf_name_the_card_and_no_tpu(reports):
    _, port_text, opened, tmp = reports
    assert "TPU" not in port_text and "v5e" not in port_text
    assert "`nvidia-smi` found no card" in port_text
    with_card = summarize.report(str(tmp / "port"), card=CARD)
    assert f"the report was written on {CARD}" in sections(with_card)[""]
    perf = [t for h, t in sections(port_text).items() if h.startswith("## Performance")][0]
    for name in ARTIFACTS:
        assert f"`{name}`" in perf
    assert perf.count(CARD) >= len(ARTIFACTS) + 1
    assert "| 8 | 100.0 | 5.000 | 7.500 | 9.000 |" in perf
    assert "| 8 | 1.200 | 1.000 | 1.100 |" in perf
    assert "| packed | 1 | 2.0 | 38.0 | 2% |" in perf


def test_perf_section_opens_only_the_cards_artifacts(reports):
    _, _, opened, tmp = reports
    assert opened and not [p for p in opened if "_v5e" in p]
    docs = sorted(p for p in opened if "/docs/" in p)
    assert [p.split("/port/")[1] for p in docs] == sorted(
        list(ARTIFACTS) + ["docs/weighted_gate_analysis.json"])


def test_main_writes_under_the_output_root(tmp_path, monkeypatch, capsys):
    """Without --stdout the report goes to <output-root>/RESULTS.md (the
    script's RESULTS.md is a file git tracks); with no results it is the
    header alone."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(summarize, "card_name", lambda: None)
    text = summarize.main(["--output-root", "runs"])
    assert (tmp_path / "runs" / "RESULTS.md").read_text() == text
    assert "## " not in text and "wrote runs/RESULTS.md" in capsys.readouterr().out
