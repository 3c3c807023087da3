"""The port's multi-process runtime (paddle_tpu_torch/parallel/
distributed.py, collective.py, the tp mesh, sharding.py) against the JAX
package's:

- `init_distributed`: the rendezvous retried through injected faults
  (the counterpart of tests/test_resilience.py's
  test_init_distributed_retries_rendezvous, with
  `torch.distributed.init_process_group` patched), and single-process
  mode when nothing is configured;
- the collective cases of tests/test_parallel.py (all_reduce, ppermute
  over ring_perm, broadcast from a root) plus all_gather,
  reduce_scatter, barrier and the axis helpers, on a gloo group of 4
  CPU ranks — four processes joined by `init_distributed` through the
  PTPU_* environment, spawned together;
- the tp mesh over a private process group, which carries no other
  multi-rank axis (a mesh over dp, fsdp and tp ranks is the world's:
  tests/test_torch_parallel.py);
- the sharding rule tables, spec for spec equal to JAX's, and the local
  slices `shard_variables` / `shard_module` cut.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.parallel import sharding as jsh
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.parallel import distributed
from paddle_tpu_torch.parallel.collective import AxisGroup
from paddle_tpu_torch.parallel.distributed import private_groups, serve_store
from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from paddle_tpu_torch.parallel.sharding import (ShardingRules, fsdp_rules,
                                                serve_tp_rules, shard_module,
                                                shard_variables,
                                                transformer_tp_rules)
from paddle_tpu_torch.resilience import chaos, shared_budget
from paddle_tpu_torch.utils.tree import flatten_with_keys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.setenv("PTPU_RETRY_SCALE", "0")   # instantaneous retries
    chaos.reset()
    shared_budget().reset()
    yield
    chaos.reset()


def _events(capsys, evt):
    return [r for r in (json.loads(line) for line in
                        capsys.readouterr().out.splitlines()
                        if line.startswith('{"evt"'))
            if r["evt"] == evt]


# -- init_distributed --------------------------------------------------------

def test_init_distributed_retries_rendezvous(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("PTPU_CHAOS_INIT_FAIL", "2")
    monkeypatch.setenv("PTPU_INIT_RETRIES", "3")
    chaos.reload()
    old = distributed._initialized
    distributed._initialized = False
    try:
        distributed.init_distributed(coordinator="127.0.0.1:1",
                                     num_processes=1, process_id=0)
        assert len(calls) == 1               # 2 injected faults absorbed
        assert len(_events(capsys, "retry")) == 2
        assert calls[0]["init_method"] == "tcp://127.0.0.1:1"
        assert (calls[0]["world_size"], calls[0]["rank"]) == (1, 0)
        assert calls[0]["backend"] == "gloo"
    finally:
        distributed._initialized = old


def test_init_distributed_alone_is_single_process(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    for var in ("PTPU_COORDINATOR", "PTPU_NUM_PROCESSES", "PTPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    old = distributed._initialized
    distributed._initialized = False
    try:
        distributed.init_distributed()
        distributed.init_distributed()       # idempotent
        assert calls == []
        assert distributed.process_count() == 1
        assert distributed.process_index() == 0
        assert distributed.is_primary()
    finally:
        distributed._initialized = old


# -- collectives on 4 gloo ranks (tests/test_parallel.py:32-57) --------------

_RANK_SCRIPT = r"""
import json, sys
import torch
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.distributed import (
    init_distributed, is_primary, process_count, process_index)
from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh

init_distributed()
r = process_index()
mesh = make_mesh(MeshConfig(tp=4), devices=["cpu"] * 4)
g = mesh.group("tp")
x = torch.arange(8.0)[2 * r:2 * r + 2]          # this rank's shard of 0..7
out = {
    "rank": r, "count": process_count(), "primary": is_primary(),
    "mesh_rank": mesh.rank, "device": str(mesh.device),
    "index": C.axis_index(g), "size": C.axis_size(g),
    "total": float(C.all_reduce(x.sum(), g)),
    "mean": float(C.all_reduce(x.sum(), g, "mean")),
    "max": C.all_reduce(x, g, "max").tolist(),
    "rotated": C.ppermute(x, g, C.ring_perm(4)).tolist(),
    "bcast": C.broadcast(x, g, root=3).tolist(),
    "gathered": C.all_gather(x, g).tolist(),
    "stacked": list(C.all_gather(x, g, tiled=False).shape),
    "scattered": C.reduce_scatter(torch.arange(8.0), g).tolist(),
    "half_ring": C.ppermute(x, g, ((0, 1), (1, 2))).tolist(),
}
C.barrier(g)
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collectives_on_four_gloo_ranks():
    """Four processes join one gloo group through init_distributed's
    PTPU_* environment; the collectives give what JAX's give under
    shard_map over an 8-element vector split 2 a rank."""
    env = dict(os.environ, PTPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               PTPU_NUM_PROCESSES="4", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO_ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT], env=dict(
            env, PTPU_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            outs.append(json.loads(next(
                ln for ln in stdout.splitlines()
                if ln.startswith("RESULT "))[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    full = np.arange(8.0)
    for r, o in enumerate(outs):
        shard = full[2 * r:2 * r + 2]
        assert (o["rank"], o["count"], o["primary"]) == (r, 4, r == 0)
        assert (o["mesh_rank"], o["index"], o["size"]) == (r, r, 4)
        assert o["device"] == "cpu"
        assert o["total"] == 28.0 and o["mean"] == 7.0
        assert o["max"] == [6.0, 7.0]
        np.testing.assert_array_equal(
            o["rotated"], full[2 * ((r - 1) % 4):2 * ((r - 1) % 4) + 2])
        assert o["bcast"] == [6.0, 7.0]
        assert o["gathered"] == full.tolist()
        assert o["stacked"] == [4, 2]
        assert o["scattered"] == (4 * full)[2 * r:2 * r + 2].tolist()
        want = (full[2 * (r - 1):2 * r].tolist() if r in (1, 2)
                else [0.0, 0.0])
        assert o["half_ring"] == want, shard


# -- the tp mesh -------------------------------------------------------------------

def test_tp_mesh_spans_the_ranks_of_a_group():
    """A tp axis over two ranks takes their group (two threads of this
    process here); each rank's mesh names its own device; a private
    group carries no other multi-rank axis, and a mesh of several ranks
    without one needs the process's world."""
    import threading

    store = serve_store(60.0)
    meshes = [None, None]

    def rank(r):
        g = private_groups(store if r == 0 else store.port, r, 2,
                           ("gloo",), 60.0)["0:gloo"]
        meshes[r] = make_mesh(MeshConfig(tp=2), devices=["cpu", "cpu"],
                              group=AxisGroup(g, "gloo"))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for r, mesh in enumerate(meshes):
        assert mesh.shape["tp"] == 2 and mesh.rank == r
        assert mesh.group("tp").rank == r and mesh.group("tp").size == 2
        assert mesh.device == torch.device("cpu")
        with pytest.raises(KeyError):
            mesh.group("dp")
    with pytest.raises(ValueError, match="only a tp axis"):
        make_mesh(MeshConfig(tp=2, dp=2), devices=["cpu"] * 4,
                  group=meshes[0].group("tp"))
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_distributed"):
            make_mesh(MeshConfig(fsdp=2), devices=["cpu"] * 2)
        with pytest.raises(RuntimeError, match="init_distributed"):
            make_mesh(MeshConfig(tp=2), devices=["cpu", "cpu"])


# -- sharding rules ----------------------------------------------------------------

def test_sharding_rules():
    rules = ShardingRules([(r"fc/weight$", ("tp", None))])
    tree = {"fc": {"weight": np.zeros((8, 4)), "bias": np.zeros(4)},
            "other": np.zeros((2, 2))}
    specs = rules.tree_specs(tree)
    assert specs["fc"]["weight"] == ("tp", None)
    assert specs["fc"]["bias"] == ()


def test_fsdp_rules_shard_largest_dim():
    rules = fsdp_rules(min_size=16)
    specs = rules.tree_specs({"big": np.zeros((4, 100)),
                              "small": np.zeros((2,))})
    assert specs["big"] == (None, "fsdp")
    assert specs["small"] == ()


@pytest.fixture(scope="module")
def lm_variables():
    """A GQA CausalLM's variables and one with fused qkv (JAX init)."""
    out = {}
    for name, kw in (("gqa", dict(num_kv_heads=2)),
                     ("fused", dict(fused_qkv=True))):
        jm = JaxCausalLM(vocab=61, model_dim=32, num_heads=4, num_layers=2,
                         ffn_dim=64, dropout=0.0, max_len=64, **kw)
        out[name] = (kw, jax.device_get(jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))))
    return out


@pytest.mark.parametrize("table", ["serve_tp", "transformer_tp", "fsdp"])
def test_rule_tables_equal_jax(lm_variables, table):
    port, ref = {"serve_tp": (serve_tp_rules(), jsh.serve_tp_rules()),
                 "transformer_tp": (transformer_tp_rules(),
                                    jsh.transformer_tp_rules()),
                 "fsdp": (fsdp_rules(min_size=64),
                          jsh.fsdp_rules(min_size=64))}[table]
    for _, variables in lm_variables.values():
        for path, leaf in flatten_with_keys(variables):
            assert port.spec_for(path, leaf.shape) == \
                tuple(ref.spec_for(path, leaf.shape)), path


@pytest.mark.parametrize("name", ["gqa", "fused"])
def test_shard_variables_and_module_give_the_rank_slices(lm_variables,
                                                         name):
    """Rank r's slices are part r of every sharded dim (what a
    NamedSharding over JAX's tp mesh places on device r); a module cut
    by shard_module loads them by path; the ranks' parts join back into
    the whole tree."""
    from jax.sharding import NamedSharding

    from paddle_tpu.parallel import MeshConfig as JaxMeshConfig
    from paddle_tpu.parallel import make_mesh as jax_make_mesh

    kw, variables = lm_variables[name]
    rules = serve_tp_rules()
    jrules = jsh.serve_tp_rules()
    mesh = jax_make_mesh(JaxMeshConfig(tp=2), devices=jax.devices()[:2])
    parts = [dict(flatten_with_keys(shard_variables(variables, rules, r, 2)))
             for r in range(2)]
    for path, leaf in flatten_with_keys(variables):
        placed = jax.device_put(leaf, NamedSharding(
            mesh, jrules.spec_for(path, leaf.shape)))
        by_dev = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        for r in range(2):
            np.testing.assert_array_equal(parts[r][path],
                                          by_dev[mesh.devices.flat[r]])
    for r in range(2):
        model = CausalLM(61, model_dim=32, num_heads=4, num_layers=2,
                         ffn_dim=64, dropout=0.0, max_len=64, device="cpu",
                         **kw)
        shard_module(model, rules, r, 2)
        load_jax_params(model, shard_variables(variables, rules, r, 2))
        attn = model.blocks[0].attn
        w = attn.qkv.weight if name == "fused" else attn.q_proj.weight
        assert w.shape == (32, (96 if name == "fused" else 32) // 2)
        assert model.blocks[0].ffn.fc2.weight.shape == (32, 32)
        assert model.embed.weight.shape == (61, 32)
