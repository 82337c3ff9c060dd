"""PyTorch port: the mesh (``repro_torch.parallel``, ``solve(mesh=)``,
``EngineConfig(mesh=)``) against the JAX package's ``repro.parallel``.

* SPEC LAYER — ``lane_axes``, ``batch_specs``, ``param_specs``,
  ``state_specs`` (ZeRO-1), ``batched_solution_specs``,
  ``solver_state_specs``, ``with_shard_load_stats`` and ``make_sharder``
  read only a mesh's sizes and names, so both packages' functions get
  ``tests/test_parallel.py``'s duck-typed ``_FakeMesh`` and are compared
  leaf by leaf.  The port keeps one LM leaf per repeat unit where JAX
  stacks R units on a leading dim; the mapping the comparison states:
  JAX's spec of a stacked leaf minus its leading (stack) entry is the
  port's spec of each unit's leaf; where JAX's ZeRO-1 puts "data" on that
  stack dim, the port's unit r is ``Owned("data", r // (R / data), rest)``:
  data rank k holds units [k R / data, (k + 1) R / data) whole.  Each data
  rank then holds the optimizer bytes a JAX device holds.
* VALIDATION — the JAX package's messages: ``mesh=`` needs
  ``batch_axis=0``, ``sharding=`` needs ``mesh=``, an engine bucket must
  be divisible by the lane shards, and a mesh with too few ranks names how
  to get them.
* THE COLLECTIVE CONTRACT — on a world of 1 over gloo in this process: a
  sharded solve's forward makes no collective, its backward exactly one
  all_reduce per parameter leaf and nothing else, counted by the port's
  own wrapper (``parallel.comm``), for JAX's three cases (symplectic
  adaptive, adjoint adaptive, symplectic fixed).
* NUMERICS ON A MESH — one spawned 4-rank gloo world (``torch_world``)
  runs ``tests/test_parallel.py``'s solve, grids, saveat, scalar-leaf,
  engine and sharder scripts on meshes (4,) and (2, 2), float64 (the
  bounds are in ``torch_world_cases``).  Sharded JAX is not run here: its
  own tests hold it against its unsharded solve, and the port's unsharded
  batched solve is held against JAX's in ``test_torch_batch.py``.
"""
import contextlib
import socket
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.parallel as jpar  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_smoke_arch as jget_smoke  # noqa: E402
from repro.core import AdaptiveConfig as JConfig  # noqa: E402
from repro.core.api import mesh_capability_matrix as jmesh_matrix  # noqa: E402
from repro.core.stepper import AdaptiveStepper as JStepper  # noqa: E402
from repro.core.tableau import get_tableau as jget_tableau  # noqa: E402
from repro.models.lm import init_lm as jinit_lm  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro_torch import parallel as par  # noqa: E402
from repro_torch.core import (AdaptiveConfig, AdaptiveStepper, get_tableau,  # noqa: E402
                              mesh_capability_matrix, solve)
from repro_torch.launch.mesh import (make_debug_mesh, make_lane_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.parallel import P, comm  # noqa: E402
from repro_torch.parallel.layout import placements  # noqa: E402
from repro_torch.serve import EngineConfig  # noqa: E402
from torch_world import run_world  # noqa: E402


class _FakeMesh:
    """Duck-typed mesh: the spec layer reads only .shape / .axis_names."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


@contextlib.contextmanager
def _quiet():
    """Silence lane_axes' warnings (checked in their own test)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _norm(spec):
    """A spec as a tuple without trailing Nones, one-axis tuples as the
    axis name (JAX's PartitionSpec normalizes both)."""
    s = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec]
    while s and s[-1] is None:
        s.pop()
    return tuple(s)


# ---------------------------------------------------------------------------
# lane_axes / batch_specs: the divisible-prefix rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,batch", [
    (dict(pod=2, data=2), 8), (dict(pod=2, data=2), 6),
    (dict(pod=2, data=2), 5), (dict(data=4), 8), (dict(data=4, model=2), 8),
    (dict(model=2), 8)])
def test_lane_axes_matches_jax(axes, batch):
    mesh = _FakeMesh(**axes)
    with _quiet():
        want = jpar.lane_axes(mesh, batch)
        got = par.lane_axes(mesh, batch)
    assert got == want
    assert par.shard_count(mesh, got) == jpar.shard_count(mesh, want)
    if not want:
        with pytest.raises(ValueError) as je:
            jpar.lane_axes(mesh, batch, require=True)
        with pytest.raises(ValueError) as pe:
            par.lane_axes(mesh, batch, require=True)
        assert str(pe.value) == str(je.value)


def test_lane_axes_warns_as_jax():
    mesh = _FakeMesh(pod=2, data=2)
    with pytest.warns(UserWarning, match="divisible prefix"):
        assert par.lane_axes(mesh, 6) == ("pod",)
    with pytest.warns(UserWarning, match="replicated"):
        assert par.lane_axes(mesh, 5) == ()
    with pytest.raises(ValueError, match="none of the data axes"):
        par.lane_axes(_FakeMesh(model=2), 8, require=True)


def test_batch_specs_matches_jax():
    mesh = _FakeMesh(pod=2, data=2)
    batch = {"x": np.zeros((6, 3)), "y": np.zeros((8,)), "s": np.zeros(()),
             "z": np.zeros((5, 2))}
    tb = {k: torch.zeros(v.shape) for k, v in batch.items()}
    with _quiet():
        want = jpar.batch_specs(batch, mesh)
        got = par.batch_specs(tb, mesh)
    for k in batch:
        assert _norm(got[k]) == _norm(want[k]), k
    assert got["x"] == P(("pod",), None)


# ---------------------------------------------------------------------------
# param_specs / state_specs on the LM: stacked (JAX) vs per unit (port)
# ---------------------------------------------------------------------------

def _path_key(path):
    out = []
    for e in path:
        for attr in ("key", "idx", "name"):
            if hasattr(e, attr):
                out.append(getattr(e, attr))
                break
    return tuple(out)


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_path_key(p): v for p, v in flat}


def _port_flat(tree):
    flat = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, par.Owned)))[0]
    return {_path_key(p): v for p, v in flat}


def _unit_of(key, prefix):
    """(JAX key, unit index) of a port key under ``prefix + ("unit", r)``."""
    n = len(prefix)
    if key[:n] == prefix and len(key) > n + 1 and key[n] == "unit":
        return key[:n + 1] + key[n + 2:], key[n + 1]
    return key, None


def _lm_trees(arch):
    """JAX's stacked params (shape-only) and the port's per-unit tree of
    meta tensors of the same shapes."""
    jparams = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), arch))
    R = arch.n_repeats

    def meta(s):
        return torch.empty(s.shape, device="meta",
                           dtype=getattr(torch, str(s.dtype)))

    port = {k: jax.tree_util.tree_map(meta, v) for k, v in jparams.items()
            if k != "unit"}
    port["unit"] = [tuple(jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape[1:], device="meta",
                              dtype=getattr(torch, str(s.dtype))), layer)
        for layer in jparams["unit"]) for _ in range(R)]
    return jparams, port


def _compare(want, got, prefix, R, dsize=None):
    """Every port leaf's spec against JAX's, through the per-unit
    mapping."""
    jw, pg = _jax_flat(want), _port_flat(got)
    seen = set()
    for key, spec in pg.items():
        jkey, r = _unit_of(key, prefix)
        js = jw[jkey]
        seen.add(jkey)
        if r is None:
            assert _norm(spec) == _norm(js), (key, spec, js)
            continue
        js = _norm(js)
        if js and js[0] == "data":
            assert isinstance(spec, par.Owned), (key, spec, js)
            assert spec.index == r // (R // dsize), (key, spec)
            assert _norm(spec.spec) == js[1:], (key, spec, js)
        else:
            assert not js or js[0] is None, (key, js)
            assert _norm(spec) == js[1:], (key, spec, js)
    assert seen == set(jw), set(jw) ^ seen


MESHES = [dict(data=2, model=2), dict(data=4), dict(data=4, model=2),
          dict(data=8), dict(pod=2, data=2, model=2)]


@pytest.mark.parametrize("arch_name", ["smoke", "full"])
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_param_specs_match_jax_per_unit(arch_name, axes):
    arch = (jget_smoke if arch_name == "smoke" else jget_arch)("qwen3-0.6b")
    mesh = _FakeMesh(**axes)
    jparams, port = _lm_trees(arch)
    for kw in ({}, {"ep": True}, {"fsdp": True}):
        _compare(jpar.param_specs(jparams, mesh, **kw),
                 par.param_specs(port, mesh, **kw), (), arch.n_repeats)


def _bytes_per_rank(flat, sizes, shapes, rank_coord):
    total = 0
    for key, spec in flat.items():
        n = int(np.prod(shapes[key])) * 4
        if isinstance(spec, par.Owned):
            if rank_coord[spec.axis] != spec.index:
                continue
            spec = spec.spec
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    n //= sizes[a]
        total += n
    return total


@pytest.mark.parametrize("arch_name", ["smoke", "full"])
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_state_specs_zero1_match_jax_per_unit(arch_name, axes):
    arch = (jget_smoke if arch_name == "smoke" else jget_arch)("qwen3-0.6b")
    mesh = _FakeMesh(**axes)
    jparams, port = _lm_trees(arch)
    jstate = {"params": jparams, "opt": jax.eval_shape(
        lambda: jadamw_init(jinit_lm(jax.random.PRNGKey(0), arch),
                            JAdamW()))}
    pstate = {"params": port, "opt": {
        "m": pytree.tree_map(lambda l: torch.empty(
            l.shape, device="meta"), port),
        "v": pytree.tree_map(lambda l: torch.empty(
            l.shape, device="meta"), port),
        "step": torch.zeros((), dtype=torch.int32)}}
    R = arch.n_repeats
    for zero1 in (True, False):
        want = jpar.state_specs(jstate, mesh, zero1=zero1)
        got = par.state_specs(pstate, mesh, zero1=zero1)
        _compare(want["params"], got["params"], (), R)
        assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"])
        for k in ("m", "v"):
            _compare(want["opt"][k], got["opt"][k], (), R,
                     axes.get("data"))
    # each data rank holds the optimizer bytes a JAX device holds
    want = jpar.state_specs(jstate, mesh)
    got = par.state_specs(pstate, mesh)
    jshapes = {k: v.shape for k, v in _jax_flat(jax.tree_util.tree_map(
        lambda s: s, jstate["opt"]["m"])).items()}
    jflat = _jax_flat(want["opt"]["m"])
    pflat = _port_flat(got["opt"]["m"])
    pshapes = {k: v.shape for k, v in _port_flat(pstate["opt"]["m"]).items()}
    coord = {a: 0 for a in axes}
    per_device = _bytes_per_rank(jflat, axes, jshapes, coord)
    for k in range(axes["data"]):
        coord["data"] = k
        assert _bytes_per_rank(pflat, axes, pshapes, coord) == per_device


def test_state_specs_train_state():
    from repro_torch.configs import get_smoke_arch
    from repro_torch.train import TrainConfig, TrainState, init_train_state
    state = init_train_state(get_smoke_arch("qwen3-0.6b"), TrainConfig(),
                             device="cpu")
    specs = par.state_specs(state, _FakeMesh(data=2, model=2))
    assert isinstance(specs, TrainState)
    assert specs.data_step == P() and specs.rng == P(None)
    assert specs.params["embed"] == P("model", None)
    assert isinstance(specs.opt["m"]["unit"][1][0]["attn"]["wq"], par.Owned)


# ---------------------------------------------------------------------------
# solve-facing placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,lane", [(dict(data=4), ("data",)),
                                       (dict(pod=2, data=2), ("pod", "data")),
                                       (dict(data=2, model=2), ("data",))])
def test_batched_solution_specs_match_jax(axes, lane):
    mesh = _FakeMesh(**axes)
    want = jpar.batched_solution_specs(lane)
    got = par.batched_solution_specs(mesh, lane)
    for name in want._fields:
        assert getattr(got, name) == placements(mesh, getattr(want, name)), \
            name
    assert par.lane_spec(mesh, lane, 1) == placements(
        mesh, jpar.lane_spec(lane, 1))


def test_solver_state_specs_match_jax():
    mesh = _FakeMesh(data=4)
    jst = JStepper(lambda x, t, p: -x, jget_tableau("bosh3"),
                   JConfig(max_steps=4), "jnp")
    pst = AdaptiveStepper(lambda x, t, p: -x, get_tableau("bosh3"),
                          AdaptiveConfig(max_steps=4), "torch")
    jb = jst.init_state(jnp.zeros((4, 2)), 0.0, 1.0, lanes=4, rtol=1e-6,
                        atol=1e-8)
    pb = pst.init_state(torch.zeros(4, 2, dtype=torch.float64), 0.0, 1.0,
                        lanes=4, rtol=1e-6, atol=1e-8)
    want = jpar.solver_state_specs(jb, ("data",))
    got = par.solver_state_specs(mesh, pb, ("data",))
    for name in ("t0", "t1", "t", "x", "h", "n_accepted", "n_attempts",
                 "n_fevals", "xs", "ts", "hs", "rtol", "atol"):
        assert getattr(got, name) == placements(mesh, getattr(want, name)), \
            name
    js = jst.init_state(jnp.zeros((2,)), 0.0, 1.0)
    ps = pst.init_state(torch.zeros(2, dtype=torch.float64), 0.0, 1.0)
    want1 = jpar.solver_state_specs(js, ("data",))
    got1 = par.solver_state_specs(mesh, ps, ("data",))
    for name in ("t0", "t1", "t", "h", "ts"):
        assert getattr(got1, name) == placements(mesh, getattr(want1, name))
    assert got1.rtol is None and want1.rtol is None


def test_with_shard_load_stats_matches_jax():
    want = jpar.with_shard_load_stats(
        {"n_steps": jnp.array([1, 2, 3, 5], jnp.int32)}, 2)
    got = par.with_shard_load_stats(
        {"n_steps": torch.tensor([1, 2, 3, 5], dtype=torch.int32)}, 2)
    np.testing.assert_array_equal(got["shard_steps"].numpy(),
                                  np.asarray(want["shard_steps"]))
    assert float(got["load_imbalance"]) == float(want["load_imbalance"])
    assert got["n_steps"].shape == (4,)


def test_make_sharder_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert par.make_sharder(None)(x, ("batch", "ffn")) is x
    # a plain (local) tensor on a mesh is the rank's own block
    assert par.make_sharder(_FakeMesh(data=2, model=2))(
        x, ("batch", "ffn")) is x
    assert par.make_sharder(None).mesh is None


def test_mesh_capability_matrix_matches_jax():
    assert mesh_capability_matrix() == jmesh_matrix()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _field(x, t, p):
    return torch.tanh(x @ p["w"])


def test_solve_mesh_validation():
    params = {"w": torch.eye(2, dtype=torch.float64) * 0.1}
    x0 = torch.ones(4, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="batch_axis=0"):
        solve(_field, x0[0], params, stepping=AdaptiveConfig(max_steps=8),
              mesh=_FakeMesh(data=4))
    with pytest.raises(ValueError, match="requires mesh="):
        solve(_field, x0, params, stepping=AdaptiveConfig(max_steps=8),
              batch_axis=0, sharding="auto")


def test_engine_config_mesh_bucket_validation():
    mesh = _FakeMesh(data=4)
    with pytest.raises(ValueError, match="divisible by 4"):
        EngineConfig(buckets=(4, 6), mesh=mesh)
    EngineConfig(buckets=(4, 8), mesh=mesh)     # whole shards: fine


def test_meshes_name_how_to_get_ranks():
    have = dist.get_world_size() if dist.is_initialized() else 0
    with pytest.raises(RuntimeError, match=f"torchrun --nproc-per-node "
                       f"{have + 1}"):
        make_debug_mesh(have + 1, 1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_lane_mesh((have + 1,))
    with pytest.raises(NotImplementedError, match="no H100 counterpart"):
        make_production_mesh()


# ---------------------------------------------------------------------------
# the collective contract, on a world of 1 in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_of_one():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield make_lane_mesh((1,), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _contract_problem():
    rng = np.random.default_rng(3)
    params = {"w1": torch.tensor(rng.standard_normal((3, 6)) * 0.3),
              "b1": torch.zeros(6, dtype=torch.float64),
              "w2": torch.tensor(rng.standard_normal((6, 3)) * 0.3)}
    x0 = torch.tensor(rng.standard_normal((4, 3)))
    return params, x0


def _cfield(x, t, p):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


@pytest.mark.parametrize("strategy,stepping", [("symplectic", "adaptive"),
                                               ("adjoint", "adaptive"),
                                               ("symplectic", "fixed")])
def test_collective_contract(world_of_one, strategy, stepping):
    mesh = world_of_one
    params, x0 = _contract_problem()
    step = AdaptiveConfig(rtol=1e-7, atol=1e-9, max_steps=64) \
        if stepping == "adaptive" else 8
    kw = dict(gradient=strategy, stepping=step, batch_axis=0)
    outs = {}
    for m in (None, mesh):
        live = pytree.tree_map(lambda l: l.clone().requires_grad_(), params)
        comm.reset_counts()
        sol = solve(_cfield, x0, live, mesh=m, **kw)
        fwd = comm.counts()
        ys = sol.ys.to_local() if m is not None else sol.ys
        g = torch.autograd.grad(torch.sum(torch.sin(ys) ** 2),
                                pytree.tree_leaves(live))
        outs[m is not None] = (fwd, comm.counts(), ys.detach(), g)
    fwd, bwd, ys, g = outs[True]
    assert fwd == {}, fwd                      # the forward is local
    assert bwd == {"all_reduce": len(pytree.tree_leaves(params))}, bwd
    assert outs[False][0] == outs[False][1] == {}
    # a world of 1: the mesh path is the unsharded solve, bit for bit
    assert torch.equal(ys, outs[False][2])
    for a, b in zip(g, outs[False][3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# numerics on 4 ranks: one spawned gloo world
# ---------------------------------------------------------------------------

MESH_CASES = (
    [f"{kind}-{m}-{g}-{s}" for kind in ("solve", "saveat")
     for m in ("4", "2x2") for g in ("symplectic", "adjoint")
     for s in ("adaptive", "fixed")]
    + ["grids-4", "scalar-4", "engine-4", "sharder-2x2"])


@pytest.fixture(scope="module")
def mesh_world():
    return run_world("torch_world_cases:mesh_cases", world=4)


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_world(mesh_world, name):
    for rank, res in enumerate(mesh_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"
