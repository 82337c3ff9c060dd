"""PyTorch port: the recording auditor (``repro_torch.analysis``), its
launcher (``launch/dryrun --analysis``) and ``launch/analysis`` against the
JAX package's ``repro.analysis``.

Three layers, as in tests/test_analysis.py:

  * the recorder on calls whose bytes are worked out by hand, and each rule
    on a planted fault beside the clean case;
  * parity with the JAX package: the enumerated case keys, and the Table-1
    growth class of every (strategy, method);
  * the whole ``--check`` on the CPU, run once for the module.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

import repro.analysis as JA
import repro.launch.analysis as JLA
from repro.analysis.memory import memory_rows as jax_memory_rows
from repro_torch.analysis import (BUDGET_PATH, OpContext, OpRecord,
                                  budget_findings, collective_findings,
                                  constant_findings, count_ops,
                                  donation_findings, dtype_findings,
                                  engine_advance_probe, enumerate_cases,
                                  flatness_findings, load_budgets,
                                  memory_findings, record, run_analysis,
                                  sharded_solve_probe)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.cases import (SHARDED_PROBE_CELLS, mlp_field,
                                        mlp_params)
from repro_torch.analysis.memory import (FLAT_STRATEGIES, LINEAR_STRATEGIES,
                                         growth_class)
from repro_torch.analysis.rules import Finding
from repro_torch.core import solve
from repro_torch.core.stepper import AdaptiveStepper
from repro_torch.launch import analysis as LA
from repro_torch.launch import dryrun
from repro_torch.parallel import comm

F64 = torch.float64


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64])
def test_recorder_peak_on_a_tanh_chain_by_hand(n):
    """n tanh layers of width 256 in float64, then the gradient of their
    sum.  Autograd saves every tanh output (n x 2048 B); the backward's
    first tanh_backward then holds its input gradient and its output
    (2 x 2048 B) with the loss and the sum's 0-dim gradient (2 x 8 B)
    while every saved output is still live."""
    w = 256
    x = torch.randn(w, dtype=F64, requires_grad=True)

    def chain(x):
        y = x
        for _ in range(n):
            y = torch.tanh(y)
        return torch.autograd.grad(y.sum(), x)

    _, rec = record(chain, x)
    assert rec.peak_bytes == n * w * 8 + 2 * w * 8 + 2 * 8
    assert rec.live_bytes == w * 8        # only the returned gradient


def test_recorder_counts_a_storage_once():
    """Views and in-place ops allocate nothing; a view keeps its storage
    live after the tensor it was cut from dies; inputs do not count."""
    x = torch.ones(1024, dtype=F64)

    def run(x):
        a = x * 2.0                       # 8 KiB
        v = a[:16]                        # a view: no bytes
        a.add_(1.0)                       # in place: no bytes
        x.mul_(1.0)                       # in place on an input: no bytes
        del a
        return v                          # keeps a's storage live

    v, rec = record(run, x)
    assert rec.peak_bytes == 1024 * 8
    assert rec.live_bytes == 1024 * 8
    assert [(r.name, r.new_bytes) for r in rec.records] == [
        ("aten.mul", 8192), ("aten.slice", 0), ("aten.add_", 0),
        ("aten.mul_", 0)]
    assert count_ops(rec) == 4 and rec.external == {}


def test_recorder_context_names_the_solver_frame():
    x0, params = mlp_params(4, 8, device="cpu")
    _, rec = record(lambda x, p: solve(mlp_field, x, p, stepping=2), x0,
                    params)
    paths = {r.context.path for r in rec.records}
    assert ("stage",) in paths and () in paths
    assert all(r.context.loop_depth == (1 if r.context.path else 0)
               for r in rec.records)


# ---------------------------------------------------------------------------
# each rule: a planted fault, and the clean case
# ---------------------------------------------------------------------------

def _bad_field(x, t, p):
    # the bug class of the JAX package's first analyzer sweep: an
    # intermediate that hardcodes float32 inside every step of a float64
    # solve
    h = torch.tanh((x @ p["w1"]).float()).double()
    return h @ p["w2"] + p["b2"]


def test_dtype_rule_flags_a_float32_cast_inside_the_field():
    x0, params = mlp_params(4, 8, device="cpu")
    _, bad = record(lambda x, p: solve(_bad_field, x, p, stepping=2).ys,
                    x0, params)
    fs = dtype_findings(bad, "planted")
    errors = [f for f in fs if f.severity == "error"]
    warnings = [f for f in fs if f.severity == "warning"]
    assert errors and all("float64 -> torch.float32" in f.message
                          and "inside stage" in f.message for f in errors)
    # the cast back up (f32 -> f64 inside a step, not to f32) warns
    assert warnings and all("float32 -> torch.float64" in f.message
                            for f in warnings)
    _, clean = record(lambda x, p: solve(mlp_field, x, p, stepping=2).ys,
                      x0, params)
    assert dtype_findings(clean, "clean") == []


def test_dtype_rule_allows_the_f32_accumulate_idiom():
    """A bf16 state upcast to exactly f32 inside a step is the accumulate
    idiom (kernels/ref.py), not a finding; a widening cast to f64 inside a
    step warns; at the top level it does not."""
    def cast(src, dst, path):
        return OpRecord("aten._to_copy", (src,), ((4,),), (dst,), ((4,),),
                        16, OpContext(path), (src, dst))

    class Rec:
        records = [cast(torch.bfloat16, torch.float32, ("step",)),
                   cast(torch.bfloat16, torch.float32, ()),
                   cast(torch.float32, F64, ())]
    assert dtype_findings(Rec, "idiom") == []
    Rec.records = [cast(torch.float32, F64, ("stage",))]
    assert [f.severity for f in dtype_findings(Rec, "wide")] == ["warning"]


def test_constant_rule_flags_a_captured_2mib_tensor():
    x0, params = mlp_params(4, 8, device="cpu")
    big = torch.ones(1 << 18, dtype=F64)          # 2 MiB, captured

    def captured(x, t, p):
        return mlp_field(x, t, p) + big[:4]

    _, rec = record(lambda x, p: solve(captured, x, p, stepping=2).ys,
                    x0, params)
    fs = constant_findings(rec, "planted")
    assert [f.severity for f in fs] == ["warning"]
    assert "2.0 MiB" in fs[0].message
    _, clean = record(lambda x, p: solve(mlp_field, x, p, stepping=2).ys,
                      x0, params)
    assert constant_findings(clean, "clean") == []


def test_in_place_rule_flags_an_attempt_that_reallocates(monkeypatch):
    clean = engine_advance_probe(device="cpu")
    assert donation_findings(clean["rec"], "clean", before=clean["before"],
                             after=clean["after"], severity="error") == []
    assert clean["before"]["xs"][1] >= 1 << 16     # the floor is cleared
    orig = AdaptiveStepper.advance_in_place

    def reallocating(self, state, params):
        orig(self, state, params)
        state.xs.set_(state.xs.clone())           # a new checkpoint buffer

    monkeypatch.setattr(AdaptiveStepper, "advance_in_place", reallocating)
    bad = engine_advance_probe(device="cpu")
    fs = donation_findings(bad["rec"], "planted", before=bad["before"],
                           after=bad["after"], severity="error")
    assert [f.severity for f in fs] == ["error", "error"]
    assert "['xs']" in fs[0].message


def test_budget_rule_ratchet():
    _, rec = record(lambda x: torch.sin(x) + 1.0, torch.zeros(2))
    n = count_ops(rec)
    assert n == 2
    key = "c:value:torch"
    assert budget_findings(rec, "c", {key: n}, "value", "torch") == []
    over = budget_findings(rec, "c", {key: n - 1}, "value", "torch")
    assert [f.severity for f in over] == ["error"]
    assert [f.severity for f in budget_findings(rec, "c", {}, "value",
                                                "torch")] == ["error"]
    slack = budget_findings(rec, "c", {key: 100 * n}, "value", "torch")
    assert [f.severity for f in slack] == ["info"]
    # the other backend's key does not stand in for this one
    assert [f.severity for f in budget_findings(
        rec, "c", {"c:value:cuda": n}, "value", "torch")] == ["error"]


def test_flatness_rule():
    assert flatness_findings("c", "value", {4: 100, 8: 200, 16: 400}) == []
    assert flatness_findings("c", "value", {4: 1184, 8: 1175, 16: 1175}) \
        == []                           # vectorized observation: ~0 each
    bad = flatness_findings("c", "value", {4: 100, 8: 200, 16: 700})
    assert [f.severity for f in bad] == ["error"]
    assert "grows with the number of observations" in bad[0].message


def test_collective_rule_flags_a_second_all_reduce(monkeypatch):
    strategy, stepping = SHARDED_PROBE_CELLS[0]
    clean = sharded_solve_probe(strategy, stepping, device="cpu")
    shapes = clean["param_shapes"]
    for kind in ("value", "grad"):
        rec, counts = clean[kind]
        assert collective_findings(counts, rec.collectives, "clean", kind,
                                   shapes) == []
    assert clean["grad"][1] == {"all_reduce": len(shapes)}
    orig, extra = comm.all_reduce, []

    def twice(t, group):
        if not extra:
            extra.append(orig(torch.zeros(7, dtype=t.dtype), group))
        return orig(t, group)

    monkeypatch.setattr(comm, "all_reduce", twice)
    bad = sharded_solve_probe(strategy, stepping, device="cpu")
    rec, counts = bad["grad"]
    fs = collective_findings(counts, rec.collectives, "planted", "grad",
                             shapes)
    assert [f.severity for f in fs] == ["error"]
    assert f"{len(shapes) + 1} all_reduce" in fs[0].message
    # a collective in the value pass
    assert [f.severity for f in collective_findings(
        {"all_reduce": 1}, [("c10d.allreduce_", ((7,),))], "v",
        "value")] == ["error"]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_case_keys_equal_jax():
    for methods in (("dopri5",), ("dopri5", "bosh3")):
        port = [(c.key, c.differentiable) for c in enumerate_cases(methods)]
        ref = [(c.key, c.differentiable)
               for c in JA.enumerate_cases(methods)]
        assert port == ref


def test_committed_budgets_cover_every_case():
    """budgets.json holds exactly one entry per recorded call of the
    current registry for the CPU's backend, and any card keys cover the
    same cases."""
    budgets = json.loads(BUDGET_PATH.read_text())
    expected = set()
    for case in enumerate_cases(("dopri5",)):
        expected.add(f"{case.key}:value")
        if case.differentiable:
            expected.add(f"{case.key}:grad")
    expected.add("serve/engine/dopri5/advance:value")
    for strategy, stepping_kind in SHARDED_PROBE_CELLS:
        key = f"parallel/{strategy}/dopri5/{stepping_kind}/t1/sharded"
        expected |= {f"{key}:value", f"{key}:grad"}
    by_backend = {}
    for k, v in budgets.items():
        head, backend = k.rsplit(":", 1)
        by_backend.setdefault(backend, set()).add(head)
        assert isinstance(v, int) and v > 0
    assert by_backend["torch"] == expected
    assert set(by_backend) <= {"torch", "cuda"}
    assert by_backend.get("cuda", expected) == expected


def test_write_budgets_keeps_the_other_backend(tmp_path):
    from repro_torch.analysis import write_budgets
    path = tmp_path / "budgets.json"
    path.write_text(json.dumps({"a:value:cuda": 5, "a:value:torch": 9,
                                "b:value:torch": 3}))
    write_budgets({"a:value:torch": 8}, path)
    assert json.loads(path.read_text()) == {"a:value:cuda": 5,
                                            "a:value:torch": 8}


@pytest.fixture(scope="module")
def report():
    """The whole ``--check`` on the CPU, once for the module."""
    return run_analysis(load_budgets(), device="cpu")


def test_run_analysis_on_the_cpu_has_no_error(report):
    assert report.ok, "\n".join(str(f) for f in report.errors)
    assert report.failed_probes == []      # PROBE_SEED: every probe succeeds
    assert {k.rsplit(":", 1)[1] for k in report.counts} == {"torch"}


def test_table1_classes_equal_jax(report):
    """Every (strategy, method): the port's growth class on live bytes
    equals the JAX package's on jaxpr liveness, and neither has a
    memory-bound finding."""
    ref = jax_memory_rows()
    assert memory_findings(report.rows) == []
    assert JA.memory_findings(ref) == []
    port = {(r.strategy, r.method): r for r in report.rows}
    assert set(port) == {(r.strategy, r.method) for r in ref}
    for r in ref:
        p = port[(r.strategy, r.method)]
        assert (p.n_small, p.n_big) == (r.n_small, r.n_big)
        assert growth_class(p.growth, r.method) == \
            growth_class(r.growth, r.method), (p, r)
        want = "flat" if r.strategy in FLAT_STRATEGIES else "linear"
        assert r.strategy in FLAT_STRATEGIES + LINEAR_STRATEGIES
        assert growth_class(p.growth, r.method) == want


def test_check_exits_one_on_an_error(report, monkeypatch, capsys):
    monkeypatch.setattr(cli, "run_analysis", lambda *a, **k: report)
    assert cli.main(["--check", "--device", "cpu"]) == 0
    planted = type(report)(
        findings=report.findings + [Finding("dtype-discipline", "error",
                                             "planted", "demotion")],
        rows=report.rows, counts=report.counts)
    monkeypatch.setattr(cli, "run_analysis", lambda *a, **k: planted)
    assert cli.main(["--check", "--device", "cpu"]) == 1
    assert "1 error(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# launch/analysis and dryrun against the JAX package's
# ---------------------------------------------------------------------------

def test_launch_analysis_matches_jax_with_its_constants():
    hw = dict(peak_flops=JLA.PEAK_FLOPS, hbm_bw=JLA.HBM_BW,
              link_bw=JLA.LINK_BW)
    for args in ((1e15, 1e12, 1e9), (1e12, 1e13, 0.0), (0.0, 0.0, 1e12),
                 (0.0, 0.0, 0.0)):
        assert LA.roofline_terms(*args, **hw) == JLA.roofline_terms(*args)
    for peak in (0, 1 << 30, 20 * 2**30):
        assert LA.hbm_headroom(peak, JLA.HBM_PER_CHIP) == \
            JLA.hbm_headroom(peak)
    for kind in ("train", "decode"):
        assert LA.model_flops_per_step(1e9, 4096, kind) == \
            JLA.model_flops_per_step(1e9, 4096, kind)
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)), "b": [rng.normal(size=7)]}
    assert LA.count_params(pytree.tree_map(torch.tensor, tree)) == \
        JLA.count_params(tree)
    assert LA.device_memory_bytes("cpu") == LA.DEFAULT_DEVICE_BYTES


def test_collective_and_upcast_bytes():
    comm.reset_counts()
    strategy, stepping = SHARDED_PROBE_CELLS[0]
    probe = sharded_solve_probe(strategy, stepping, device="cpu")
    nbytes = 8 * sum(int(np.prod(s)) for s in probe["param_shapes"])
    assert LA.collective_bytes()["all_reduce"] == nbytes
    x = torch.ones(4096, dtype=torch.bfloat16)
    _, rec = record(lambda x: (x.float(), x[:8].float()), x)
    assert LA.bf16_upcast_bytes(rec, min_bytes=4096 * 4) == 4096 * 4
    assert LA.bf16_upcast_bytes(rec) == 0


def test_dryrun_analysis_rows_have_jax_keys(monkeypatch, capsys):
    # the JAX launcher sets XLA_FLAGS when imported outside --analysis:
    # keep the environment as it was
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as JD
    ref = JD.run_static_analysis(("node",), verbose=False)
    rows = dryrun.run_static_analysis(("node",), device="cpu",
                                      verbose=False)
    assert [set(r) for r in rows] == [set(r) for r in ref]
    for r, j in zip(rows, ref):
        assert (r["strategy"], r["method"], r["configs"]) == \
            (j["strategy"], j["method"], j["configs"])
        assert growth_class(r["growth"], r["method"]) == \
            growth_class(j["growth"], j["method"])
    assert "static analysis OK" in capsys.readouterr().out


def test_dryrun_cells_on_meta(monkeypatch):
    import jax
    from repro.configs import get_arch as j_get_arch
    from repro.models import lm as jlm
    # the JAX launcher sets XLA_FLAGS when first imported: keep the
    # environment as it was
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as JD
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_applicable
    rows = dryrun.main(["--all", "--device", "cpu"])
    assert [(r["arch"], r["shape"]) for r in rows] == [
        (a, s) for a in ARCH_IDS for s in SHAPES
        if cell_is_applicable(a, s)]
    by_cell = {(r["arch"], r["shape"]): r for r in rows}
    train = by_cell[("qwen3-0.6b", "train_4k")]
    parts = train["bytes_per_device"]
    assert train["n_params"] == 596049920
    # bfloat16 params and grads (the JAX dry run's param_dtype), float32
    # m, v and masters, the int32 step
    assert parts["params"] == parts["grads"] == 2 * train["n_params"]
    assert parts["opt_state"] == 3 * 4 * train["n_params"] + 4
    assert train["hbm_headroom"]["fits"]
    # the MoE archs' parameter counts are the JAX package's init's
    for arch_id in ("deepseek-v2-lite-16b", "mixtral-8x7b"):
        shapes = jax.eval_shape(
            lambda k, a=arch_id: jlm.init_lm(k, j_get_arch(a)),
            jax.random.PRNGKey(0))
        want = sum(int(l.size) for l in jax.tree_util.tree_leaves(shapes))
        assert by_cell[(arch_id, "train_4k")]["n_params"] == want
        assert by_cell[(arch_id, "train_4k")]["n_active_params"] == \
            JD.active_params(j_get_arch(arch_id), want)
    # the recurrent archs' and the enc-dec model's too (jamba whole: 51.6 B)
    from repro.models import encdec as jed
    for arch_id in ("jamba-v0.1-52b", "xlstm-1.3b", "seamless-m4t-medium"):
        init = jed.init_encdec if j_get_arch(arch_id).encdec else \
            jlm.init_lm
        shapes = jax.eval_shape(
            lambda k, a=arch_id, f=init: f(k, j_get_arch(a)),
            jax.random.PRNGKey(0))
        want = sum(int(l.size) for l in jax.tree_util.tree_leaves(shapes))
        assert by_cell[(arch_id, "train_4k")]["n_params"] == want
        assert by_cell[(arch_id, "prefill_32k")]["bytes_per_device"][
            "caches"] > 0
    with pytest.raises(NotImplementedError, match="no H100 counterpart"):
        dryrun.main(["--multipod"])
