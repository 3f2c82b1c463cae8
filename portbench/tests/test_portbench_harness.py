"""The harness on the CPU: pieces found by name, a new configuration, mix,
cell and metric added as files only, the result line's keys, the import
guard, the trace reduction and the readers."""
import ast
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

from _small import CELLS, small
from portbench.lib import guard, runner, spec
from portbench.lib import trace as tr
from portbench.lib.traffic import make_pool, sub_seed

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2**31 + 7


def test_benchmark_json_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert set(c["reduced"]) <= set(doc) and c["reduced"] == doc["reduced"]
        assert c["source"] == doc["source"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_found_by_name(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    dims = cell.config.dims(cell.config_doc)
    assert dims["vocab"] == cell.config_doc["vocab_size"]
    assert {"sample_prefills", "limits"} <= set(cell.limits)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"prefill_tokens_per_s",
                                                   "setup_s"}


def _digests(path: pathlib.Path) -> dict:
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_mix_cell_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, mix, cell and metric, added to a copy of
    the benchmark as new files and new BENCHMARK.json entries, load by name;
    no file that was there changes."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    for ext in ("json", "py"):
        shutil.copy(bench_dir / "configs" / f"mixtral-8x22b.{ext}",
                    bench_dir / "configs" / f"tiny-moe.{ext}")
    shutil.copy(bench_dir / "reference" / "mixtral-8x22b.py",
                bench_dir / "reference" / "tiny-moe.py")
    (bench_dir / "traffic" / "prefill-3x64.json").write_text(json.dumps(
        {"loop": "closed", "batch": 3, "prompt_len": 64, "distinct_batches": 4,
         "ids": {"law": "uniform"}}))
    (bench_dir / "limits" / "tiny-moe.prefill-3x64.json").write_text(json.dumps(
        {"sample_prefills": 1, "limits": {"logit_rel_err": 1e-3,
                                          "top_token_gap": 1e-3}}))
    (bench_dir / "metrics" / "ops_seconds.prefill.py").write_text(
        "def read(ctx):\n    return ctx.trace.seconds() or None\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny-moe",
                                 file="portbench/configs/tiny-moe.json"))
    bench["workloads"].append({"name": "tiny-moe.prefill-3x64", "config": "tiny-moe",
                               "traffic": "prefill-3x64", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "ops_seconds.prefill", "unit": "s",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "prefill_tokens_per_s",
                               "workloads": ["tiny-moe.prefill-3x64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("tiny-moe.prefill-3x64", bench_dir=bench_dir)
    assert cell.traffic["batch"] == 3
    assert "ops_seconds.prefill" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("ops_seconds.prefill", bench_dir).read
    pool = make_pool(cell.traffic, 256, SEED, "cpu")
    assert pool.shape == (4, 3, 64) and int(pool.max()) < 256
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_traffic_is_the_seeds():
    mix = {"loop": "closed", "batch": 2, "prompt_len": 16, "distinct_batches": 3,
           "ids": {"law": "uniform"}}
    a, b = make_pool(mix, 100, SEED, "cpu"), make_pool(mix, 100, SEED, "cpu")
    assert a.shape == (3, 2, 16) and bool((a == b).all())
    assert not bool((a == make_pool(mix, 100, SEED + 1, "cpu")).all())
    assert sub_seed(2**40, 0) != sub_seed(2**40, 1) < 2**63
    with pytest.raises(ValueError):
        make_pool(dict(mix, loop="open"), 100, SEED, "cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    cell, dims, mix = small("mamba2-2.7b.prefill-16x4096")
    result = runner.run(cell, SEED, 0.3, bool(trace), started=time.time(),
                        device="cpu", dims=dims, mix=mix)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"logit_rel_err", "top_token_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro", "jax.numpy", "flax.linen",
                                    "jaxlib.xla_client", "numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert guard.forbidden_modules(["repro_torch", "repro_torch.kernels.ops",
                                    "reprox", "jaxtyping", "portbench"]) == []


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & guard.FORBIDDEN
    if "reference" in path.parts:
        assert found <= {"__future__", "contextlib", "math", "torch",
                         "portbench"}


def test_references_load_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from portbench.lib import spec\n"
            "for c in spec.benchmark()['configs']: spec.config_parts(c['name'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]\n"
            "assert not bad, bad\n") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


# --- the trace reduction and the readers, on a hand-made trace -------------

def _events():
    E = tr.Event
    return [
        E("portbench.window", "user_annotation", False, 0, 1000, 0, 1),
        E("aten::mm", "cpu_op", False, 10, 40, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 20, 25, 7, 99),
        E("aten::add", "cpu_op", False, 50, 60, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 52, 55, 8, 99),
        E("cudaLaunchKernel", "cuda_runtime", False, 70, 75, 9, 99),
        E("cudaStreamSynchronize", "cuda_runtime", False, 600, 1000, 0, 99),
        E("sm90_xmma_gemm_bf16", "kernel", True, 100, 300, 7),
        E("elementwise_kernel", "kernel", True, 300, 400, 8),
        E("flash_wgmma_kernel<112>", "kernel", True, 500, 600, 9),
        E("Memcpy DtoH", "gpu_memcpy", True, 900, 950, 10),
        E("outside", "kernel", True, 2000, 2100, 11),
    ]


def test_trace_reduction():
    t = tr.reduce(_events(), "portbench.window", prefills=2)
    assert [o.in_aten for o in t.ops] == [True, True, False, None]
    assert t.window_s == 1e-6 and t.busy_s == pytest.approx(450e-9)
    assert t.idle_gaps() == [(0, 100), (400, 500), (600, 900), (950, 1000)]
    idle = dict(t.idle_by_host())
    assert idle["cudaStreamSynchronize"] == pytest.approx(350e-9)
    assert idle["aten::add"] == pytest.approx(100e-9)
    assert idle["(no host op)"] == pytest.approx(100e-9)
    assert t.top_ops(1) == [["sm90_xmma_gemm_bf16", 200e-9]]
    d = tr.reduce_device([e for e in _events() if e.on_device], prefills=2)
    assert (d.t0, d.t1, d.count()) == (100, 2100, 5)
    assert d.busy_s == pytest.approx(550e-9)


def test_readers_on_a_hand_made_trace():
    t = tr.reduce(_events(), "portbench.window", prefills=2)
    work = {"flop": 1e6, "matmul_flop": 4e5, "flash": [(1e5, 2e3)] * 3}
    ctx = runner.TraceContext(t, t, work)

    def read(name):
        return spec.metric_reader(name).read(ctx)

    assert read("device_idle_share.prefill") == pytest.approx(0.55)
    assert read("kernel_launches.prefill") == 2.0
    # glue: the elementwise kernel and the copy, of 450 ns
    assert read("glue_share.prefill") == pytest.approx(150 / 450)
    assert read("mfu.prefill") == pytest.approx(100 * 2e6 / 1e-6 / 989e12)
    assert read("matmul_roofline.prefill") == pytest.approx(
        100 * 8e5 / 989e12 / 200e-9)
    flash = 6 * max(2e3 / 3.35e12, 1e5 / 989e12)
    assert read("flash_attention_roofline.prefill") == pytest.approx(
        100 * flash / 100e-9)
    assert read("ssd_scan_roofline.prefill") is None


# --- the comparison -------------------------------------------------------

def test_judge_leaves_near_ties_out_of_the_worst_prompt_numbers():
    import numpy as np

    from portbench.lib import check

    rng = np.random.default_rng(1)
    ref = rng.normal(size=(4, 50))
    got = ref + 1e-3 * rng.normal(size=ref.shape)
    got[2] = rng.normal(size=50)                  # a turned route's answer
    limits = {"logit_rel_err": 0.1, "logit_rel_err_median": 0.1,
              "top_token_gap": 0.5}
    checks, failed = check.judge(got, ref, limits)
    assert failed == 1 and checks["logit_rel_err"]["value"] > 1.0
    kept = np.array([True, True, False, True])
    checks, failed = check.judge(got, ref, limits, kept)
    assert failed == 0 and checks["logit_rel_err"]["value"] < 0.01
    assert checks["logit_rel_err_median"]["value"] < 0.01
    got[[0, 1]] = got[[1, 0]]                     # half the answers swapped:
    _, failed = check.judge(got, ref, limits, kept)   # the median catches it
    assert failed == 3
