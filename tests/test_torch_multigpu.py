"""PyTorch port: what the distributed run needs to take one card a rank
over NCCL (parallel/distributed.py), checked on the CPU with no process
group and no card.

  * `rank_device`: "cuda" with no index gives rank r the card r (r modulo
    the card count under gloo), an explicit index is kept, and NCCL, which
    takes one card a rank, refuses more ranks than cards or one card for
    every rank;
  * `launch_local` builds the kernel library in the calling process before
    it spawns the ranks, and each rank selects its own card;
  * the pairing of the halo exchanges.  NCCL ignores the tags of
    point-to-point ops: it pairs the sends from rank A to rank B with the
    receives B posts from A in the order each posts them.  Each rank of a
    hand-built `Mesh(world, rank)` runs in a thread of its own, and
    `dist.batch_isend_irecv` is replaced by an emulation of that rule:
    every rank posts its batch, then each receive takes the same-numbered
    send its peer posted to it.  For meshes of 2, 3, 4, 6 and 8 ranks, in
    both layouts (the rows layout's deep halo of two blocks and its one-row
    halo, the 2-D layout's four one-cell edges, and the one-line extension
    with corners, whose second batch sends the first one's result), the
    sequence of (shape, dtype) each rank sends to another equals the
    sequence of receives the other posts from it, tags left out, and every
    halo holds the neighbour's lines of a global field (zero past its
    edges), so two messages of one shape cannot be swapped unseen.  A batch
    empty on one rank but not on another would leave the others waiting at
    the emulation's barrier, which fails the test;
  * under NCCL a collective refuses a tensor off the rank's card: nothing
    is staged through host memory.
"""

import concurrent.futures
import pathlib
import pickle
import threading
import types

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.ops.cuda import _build
from hpcclassmultigridproject_tpu_torch.parallel import (
    GridBlocks,
    Mesh,
    RowBlocks,
    blocks,
    distributed,
    halo,
    rows_halo,
)
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    rank_device,
)

WORLDS = (2, 3, 4, 6, 8)


@pytest.mark.parametrize("device, backend, world, cards, want", [
    ("cuda", "nccl", 4, 4, [f"cuda:{r}" for r in range(4)]),
    ("cuda", "gloo", 4, 4, [f"cuda:{r}" for r in range(4)]),
    ("cuda", "gloo", 6, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3",
                            "cuda:0", "cuda:1"]),
    ("cuda", "gloo", 4, 1, ["cuda:0"] * 4),
    ("cuda:0", "gloo", 4, 1, ["cuda:0"] * 4),
    ("cuda:2", "gloo", 2, 4, ["cuda:2"] * 2),
    ("cuda:0", "nccl", 1, 1, ["cuda:0"]),
    ("cuda", "nccl", 1, 4, ["cuda:0"]),
    ("cpu", "nccl", 2, 0, ["cpu", "cpu"]),
    (None, "gloo", 2, 0, [None, None]),
])
def test_rank_device(monkeypatch, device, backend, world, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = [rank_device(device, r, world, backend) for r in range(world)]
    assert [None if d is None else str(d) for d in got] == want


@pytest.mark.parametrize("device, world, cards, words", [
    ("cuda", 5, 4, ["5 ranks", "4 cards"]),
    ("cuda", 2, 1, ["2 ranks", "1 cards"]),
    ("cuda:0", 2, 4, ["2 ranks", "cuda:0"]),
])
def test_rank_device_nccl_refuses_a_shared_card(monkeypatch, device, world,
                                                cards, words):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for rank in range(world):
        with pytest.raises(ValueError) as err:
            rank_device(device, rank, world, "nccl")
        assert all(w in str(err.value) for w in words)


def _fake_spawn(calls):
    """An `mp.spawn` that runs no process: it records its call and writes
    rank 0's result where `launch_local` reads it."""

    def spawn(fn, args, nprocs, join):
        calls.append(("spawn", nprocs, args[-1]))
        tmp = args[-2]
        with open(pathlib.Path(tmp) / "result.pkl", "wb") as f:
            pickle.dump("rank 0's result", f)

    return spawn


@pytest.mark.parametrize("device, backend, built", [
    ("cuda", "nccl", True),
    ("cuda:0", "gloo", True),
    ("cpu", "gloo", False),
    (None, "gloo", False),
])
def test_launch_local_builds_before_spawning(monkeypatch, device, backend,
                                             built):
    import torch.multiprocessing as mp

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
    monkeypatch.setattr(mp, "spawn", _fake_spawn(calls))
    out = distributed.launch_local(print, 4, backend=backend, device=device)
    assert out == "rank 0's result"
    want = ["build"] if built else []
    assert calls == want + [("spawn", 4, device)]


def test_launch_local_refuses_before_building(monkeypatch):
    import torch.multiprocessing as mp

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
    monkeypatch.setattr(mp, "spawn", _fake_spawn(calls))
    with pytest.raises(ValueError, match="8 ranks, 4 cards"):
        distributed.launch_local(print, 8, backend="nccl", device="cuda")
    assert calls == []


@pytest.mark.parametrize("rank", range(4))
def test_rank_main_selects_the_ranks_card(monkeypatch, tmp_path, rank):
    selected = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", selected.append)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    distributed._rank_main(rank, int, 4, (), "nccl", str(tmp_path), "cuda")
    assert selected == [torch.device("cuda", rank)]
    assert (tmp_path / "result.pkl").is_file() == (rank == 0)


class _NcclEmulation:
    """`dist.batch_isend_irecv` for ranks that are threads of this process,
    pairing as NCCL does: by order per (sender, receiver), tags ignored.
    Each batch posted is logged per rank as (op, peer, shape, dtype)."""

    def __init__(self, world: int):
        self.barrier = threading.Barrier(world, timeout=20)
        self.local = threading.local()
        self.posted = {}
        self.log = {r: [] for r in range(world)}

    def batch(self, ops):
        rank = self.local.rank
        self.posted[rank] = ops
        self.log[rank].append([(op.op, op.peer, tuple(op.tensor.shape),
                                op.tensor.dtype) for op in ops])
        self.barrier.wait()  # every rank has posted
        try:
            for peer in {op.peer for op in ops}:
                recvs = [op for op in ops
                         if op.op is dist.irecv and op.peer == peer]
                sends = [op for op in self.posted[peer]
                         if op.op is dist.isend and op.peer == rank]
                assert len(recvs) == len(sends), (rank, peer)
                for recv, send in zip(recvs, sends):
                    assert recv.tensor.shape == send.tensor.shape, (rank,
                                                                    peer)
                    assert recv.tensor.dtype == send.tensor.dtype, (rank,
                                                                    peer)
                    recv.tensor.copy_(send.tensor)
        except AssertionError:
            self.barrier.abort()  # the other ranks fail at once
            raise
        self.barrier.wait()  # every receive is filled
        return [types.SimpleNamespace(wait=lambda: None)]

    def run(self, world: int, fn):
        """fn(rank) in one thread per rank; the results in rank order."""

        def as_rank(rank):
            self.local.rank = rank
            return fn(rank)

        with concurrent.futures.ThreadPoolExecutor(world) as pool:
            futures = [pool.submit(as_rank, r) for r in range(world)]
            return [f.result() for f in futures]


def _p2p_op(op, tensor, peer, tag=0):
    return types.SimpleNamespace(op=op, tensor=tensor, peer=peer, tag=tag)


def _global(shape, dtype, sign=1.0):
    """A field whose every node holds a distinct nonzero value."""
    rows, cols = shape
    return sign * (torch.arange(rows * cols, dtype=dtype).reshape(rows, cols)
                   + 1)


def _window(g, r0, r1, c0, c1, pad):
    """g[r0:r1, c0:c1] of the global field, zero past its edges."""
    p = F.pad(g, (pad, pad, pad, pad))
    return p[r0 + pad:r1 + pad, c0 + pad:c1 + pad]


def _part(layout: str, mesh: Mesh):
    nx, ny = mesh.shape
    if layout == "rows":
        return RowBlocks(mesh, local=16, rows=16 * mesh.world, cols=12,
                         halo=8)
    return GridBlocks(mesh, local=6, local_cols=10, rows=6 * nx,
                      cols=10 * ny)


def _block(g, part):
    return g[part.start:part.stop, part.col_start:part.col_stop].clone()


def _rows_exchange(k, nblocks):
    """rows_halo.exchange of (u in f32, rhs in f64), or of u alone, and
    the (top, bottom) halos each block must receive."""

    def case(part, fields):
        fields = fields[:nblocks]
        blocks_ = [_block(g, part) for g in fields]
        got = rows_halo.exchange(blocks_, k, part.mesh)
        want = [(_window(g, part.start - k, part.start, 0, part.cols, k),
                 _window(g, part.stop, part.stop + k, 0, part.cols, k))
                for g in fields]
        return got, want

    return case


def _edges(part, fields):
    """halo.py's four one-cell edges of a 2-D block."""
    (g,) = fields[:1]
    u = _block(g, part)
    got = halo._start_halo(u, part.mesh).wait()
    r0, r1, c0, c1 = part.start, part.stop, part.col_start, part.col_stop
    want = [(_window(g, r0 - 1, r0, c0, c1, 1), _window(g, r1, r1 + 1, c0,
                                                        c1, 1)),
            (_window(g, r0, r1, c0 - 1, c0, 1), _window(g, r0, r1, c1,
                                                        c1 + 1, 1))]
    return got, want


def _extend(part, fields):
    """blocks.extend: a one-line halo on each side, corners included in
    the 2-D layout (rows, then columns of the row-extended blocks)."""
    got = blocks.extend([_block(g, part) for g in fields], part)
    r0, r1 = part.start - 1, part.stop + 1
    if isinstance(part, GridBlocks):
        c0, c1 = part.col_start - 1, part.col_stop + 1
    else:
        c0, c1 = 0, part.cols
    return got, [_window(g, r0, r1, c0, c1, 1) for g in fields]


CASES = {
    "rows deep halo (u, rhs), 8 rows": ("rows", _rows_exchange(8, 2)),
    "rows one row (u)": ("rows", _rows_exchange(1, 1)),
    "2d four edges": ("2d", _edges),
    "rows extend": ("rows", _extend),
    "2d extend with corners": ("2d", _extend),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_exchange_pairs_by_order(monkeypatch, world, case):
    layout, run_case = CASES[case]
    nccl = _NcclEmulation(world)
    monkeypatch.setattr(dist, "batch_isend_irecv", nccl.batch)
    monkeypatch.setattr(dist, "P2POp", _p2p_op)
    shape = _part(layout, Mesh(world, 0))
    shape = (shape.rows, shape.cols)
    fields = [_global(shape, torch.float32),
              _global(shape, torch.float64, sign=-1.0)]

    results = nccl.run(world, lambda r: run_case(_part(layout,
                                                       Mesh(world, r)),
                                                 fields))
    for got, want in results:
        flat = lambda xs: [t for x in xs for t in
                           (x if isinstance(x, tuple) else (x,))]
        assert len(flat(got)) == len(flat(want))
        for g, w in zip(flat(got), flat(want)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)

    # the sequences of sends and receives of every pair, batch by batch
    batches = {len(log) for log in nccl.log.values()}
    assert len(batches) == 1
    for b in range(batches.pop()):
        for a in range(world):
            for peer in range(world):
                sent = [(s, d) for op, p, s, d in nccl.log[a][b]
                        if op is dist.isend and p == peer]
                received = [(s, d) for op, p, s, d in nccl.log[peer][b]
                            if op is dist.irecv and p == a]
                assert sent == received, (b, a, peer)


@pytest.mark.parametrize("world", WORLDS)
def test_edge_ranks_post_a_batch(world):
    """Every rank of a mesh axis with two ranks or more has a neighbour on
    it, so the first batch of a group, which NCCL needs every rank in, is
    posted by every rank; an axis of one rank gives none a neighbour."""
    for axis in (0, 1):
        has = []
        for rank in range(world):
            up, down, left, right = Mesh(world, rank).neighbors
            pair = (up, down) if axis == 0 else (left, right)
            has.append(any(p is not None for p in pair))
        assert len(set(has)) == 1
        assert has[0] == (Mesh(world, 0).shape[axis] > 1)


def test_nccl_refuses_a_tensor_off_the_card(monkeypatch):
    posted = []
    monkeypatch.setattr(Mesh, "backend", property(lambda self: "nccl"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(dist, "batch_isend_irecv", posted.append)
    mesh = Mesh(4, 1)
    x = torch.zeros(16, 12)
    with pytest.raises(ValueError, match="cpu.*NCCL.*cuda:1"):
        distributed.host_staged(mesh, x)
    with pytest.raises(ValueError, match="NCCL"):
        rows_halo.start_exchange([x], 1, mesh)
    assert posted == []
