"""The port's multi-process runtime and overlapped TP matmuls
(tiny_llm_tpu_torch.parallel: initialize, Topology, runtime_topology,
make_multihost_mesh, host_local_requests, barrier, allgather_matmul,
matmul_reducescatter, overlapped_tp_matmuls) in one process on the CPU,
against the JAX package's (tests/test_distributed.py's cases on
tests/conftest.py's 8 virtual devices). Ranks: tests/test_torch_ranks.py."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tiny_llm_tpu_torch.parallel.distributed as port_dist  # noqa: E402
from tiny_llm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tiny_llm_tpu.parallel import overlapped_tp_matmuls as jax_overlapped  # noqa: E402
from tiny_llm_tpu.parallel.distributed import Topology as JaxTopology  # noqa: E402
from tiny_llm_tpu.parallel.distributed import host_local_requests as jax_host_local  # noqa: E402
from tiny_llm_tpu.parallel.distributed import runtime_topology as jax_topology  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    LocalRing,
    Topology,
    allgather_matmul,
    barrier,
    host_local_requests,
    initialize,
    make_mesh,
    make_multihost_mesh,
    matmul_reducescatter,
    overlapped_tp_matmuls,
    runtime_topology,
)

from .utils import assert_allclose  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = [torch.device("cpu")] * 8
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS")


def _clear_launcher(monkeypatch):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_initialize_is_noop_single_process(monkeypatch, device):
    """test_distributed.py:34 on the port: with no launcher in the
    environment nothing is joined, on either backend."""
    _clear_launcher(monkeypatch)
    assert initialize(device=device) is False
    assert not dist.is_initialized()


def test_initialize_needs_more_than_one_rank_from_a_launcher(monkeypatch):
    """A launcher's group of one rank (WORLD_SIZE=1) is a single process."""
    _clear_launcher(monkeypatch)
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1"), ("WORLD_SIZE", "1"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    assert initialize() is False
    assert not dist.is_initialized()


def test_initialize_never_switches_backend(monkeypatch, tmp_path):
    """The default backend is the card's: without one, an explicit address
    raises and leaves no group behind (no fall back to gloo)."""
    _clear_launcher(monkeypatch)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AttributeError, AssertionError)):
        initialize(f"file://{tmp_path / 'store'}", num_processes=1, process_id=0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="device"):
        initialize(f"file://{tmp_path / 'store'}", num_processes=1, process_id=0, device="tpu")


def test_runtime_topology_single_process():
    """test_distributed.py:42 on the port: the fields JAX reads for its 8
    virtual devices, read for the mesh [cpu] * 8; the default is the card."""
    topo = runtime_topology(CPU8)
    want = jax_topology()
    assert (topo.num_processes, topo.process_index, topo.num_devices, topo.num_local_devices,
            topo.num_slices) == (want.num_processes, want.process_index, want.num_devices,
                                 want.num_local_devices, want.num_slices) == (1, 0, 8, 8, 1)
    assert topo.devices_per_slice == want.devices_per_slice == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime_topology()


def test_make_multihost_mesh_single_slice_matches_make_mesh():
    """test_distributed.py:51 on the port."""
    mesh = make_multihost_mesh(dp=2, tp=4, devices=CPU8)
    assert mesh.shape == {"dp": 2, "tp": 4} == dict(jax_make_mesh(dp=2, tp=4).shape)
    assert mesh == make_mesh(dp=2, tp=4, devices=CPU8)
    with pytest.raises(ValueError):
        make_multihost_mesh(dp=3, tp=4, devices=CPU8)


def test_multislice_constraints_enforced(monkeypatch):
    """test_distributed.py:58 on the port, under a faked 2-node Topology:
    dp not a multiple of the nodes, and tp wider than a node, raise; a
    (2, 4) mesh over 2 nodes of 4 keeps each tp group on one node."""
    topo = Topology(num_processes=2, process_index=0, num_devices=8, num_local_devices=4,
                    num_slices=2)
    monkeypatch.setattr(port_dist, "runtime_topology", lambda devices=None: topo)
    with pytest.raises(ValueError, match="multiple of the slice count"):
        make_multihost_mesh(dp=1, tp=8, devices=CPU8)
    with pytest.raises(ValueError, match="stay on NVLink"):
        make_multihost_mesh(dp=2, tp=8, devices=CPU8 * 2)
    devs = [torch.device("cpu", i) for i in range(8)]  # rank order: node 0's four, node 1's
    mesh = make_multihost_mesh(dp=2, tp=4, devices=devs)
    for d in range(2):
        assert {x.index // 4 for x in mesh.devices_along("tp", dp=d)} == {d}


def test_host_local_requests_strides():
    """test_distributed.py:79 on the port: the same strides as JAX's."""
    reqs = list(range(10))
    assert host_local_requests(reqs, Topology(1, 0, 8, 8, 1)) == reqs
    a = host_local_requests(reqs, Topology(2, 0, 8, 4, 2))
    b = host_local_requests(reqs, Topology(2, 1, 8, 4, 2))
    assert sorted(a + b) == reqs and a == [0, 2, 4, 6, 8]
    for n, i in ((1, 0), (2, 0), (2, 1), (3, 2)):
        assert host_local_requests(reqs, Topology(n, i, 8, 8 // n, n)) == jax_host_local(
            reqs, JaxTopology(n, i, 8, 8 // n, n))
    assert host_local_requests(reqs) == reqs  # one process


def test_barrier_noop_single_process():
    barrier("test")  # must not raise or hang


def _overlap(kind: str, x, w):
    """The port's in-process pair on the mesh [cpu] * 8 against JAX's on
    its 8 virtual devices: (port output, JAX output), each [B, N]."""
    mesh = make_mesh(tp=8, devices=CPU8)
    jmesh = jax_make_mesh(dp=1, tp=8)
    w_dim = 1 if kind == "qkv" else 0
    port = overlapped_tp_matmuls(mesh)[kind != "qkv"]
    got = port(list(torch.from_numpy(x).chunk(8, 1)), list(torch.from_numpy(w).chunk(8, w_dim)))
    jfn = jax_overlapped(jmesh)[kind != "qkv"]
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(None, "tp")))
    ws = jax.device_put(jnp.asarray(w), NamedSharding(jmesh, P(*((None, "tp") if w_dim
                                                                 else ("tp", None)))))
    return torch.cat(got, dim=1).numpy(), np.asarray(jax.jit(jfn)(xs, ws))


@pytest.mark.parametrize("b,k,n", [(4, 64, 32), (1, 128, 256)])
def test_allgather_matmul_exact(b, k, n):
    """test_distributed.py:100 on the port (tp = 8, f32): within 1e-4 of
    JAX's output and of x @ w."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got, want = _overlap("qkv", x, w)
    assert_allclose(got, want, atol=1e-4)
    assert_allclose(got, x @ w, atol=1e-4)


@pytest.mark.parametrize("b,k,n", [(4, 64, 32), (2, 256, 128)])
def test_matmul_reducescatter_exact(b, k, n):
    """test_distributed.py:114 on the port."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got, want = _overlap("oproj", x, w)
    assert_allclose(got, want, atol=1e-4)
    assert_allclose(got, x @ w, atol=1e-4)


def test_overlap_chain_composes():
    """test_distributed.py:128 on the port: qkv_style's output parts are
    oproj_style's input parts, with no resharding between them."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    w1 = rng.standard_normal((64, 128)).astype(np.float32)
    w2 = rng.standard_normal((128, 64)).astype(np.float32)
    qkv_style, oproj_style = overlapped_tp_matmuls(make_mesh(tp=8, devices=CPU8))
    got = oproj_style(qkv_style(list(torch.from_numpy(x).chunk(8, 1)),
                                list(torch.from_numpy(w1).chunk(8, 1))),
                      list(torch.from_numpy(w2).chunk(8, 0)))
    assert_allclose(torch.cat(got, dim=1).numpy(), (x @ w1) @ w2, atol=1e-4)


@pytest.mark.parametrize("kind", ["qkv", "oproj"])
def test_overlap_bf16_is_bf16_products_summed_in_f32(kind):
    """bf16 operands: each band an f32 product of the bf16 values, the sum
    in f32, one rounding to bf16; so the result is the f32 product of the
    whole bf16 operands rounded once, up to the order of the f32 sums
    (one bf16 ulp), and within the bf16 ladder of JAX's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    ring = LocalRing(CPU8)
    if kind == "qkv":
        got = allgather_matmul(list(xb.chunk(8, 1)), list(wb.chunk(8, 1)), ring)
    else:
        got = matmul_reducescatter(list(xb.chunk(8, 1)), list(wb.chunk(8, 0)), ring)
    got = torch.cat(got, dim=1)
    assert got.dtype == torch.bfloat16
    exact = xb.double() @ wb.double()
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-126))) - 7)
    assert bool(((got.double() - exact).abs() <= ulp + 256 * 2.0**-24 *
                 (xb.double().abs() @ wb.double().abs())).all())
    jmesh = jax_make_mesh(dp=1, tp=8)
    jfn = jax_overlapped(jmesh)[kind != "qkv"]
    xs = jax.device_put(jnp.asarray(x, jnp.bfloat16), NamedSharding(jmesh, P(None, "tp")))
    ws = jax.device_put(jnp.asarray(w, jnp.bfloat16),
                        NamedSharding(jmesh, P(None, "tp") if kind == "qkv" else P("tp", None)))
    assert_allclose(got.float().numpy(), np.asarray(jax.jit(jfn)(xs, ws), np.float32),
                    jnp.bfloat16)


def test_overlapped_tp_matmuls_needs_a_ring():
    with pytest.raises(ValueError, match="mesh or a process group"):
        overlapped_tp_matmuls()
