"""The PyTorch port's all-to-all transpose (K2) on the host: its plain
version against the JAX package's Pallas kernel in interpret mode on the
4-device virtual mesh (run as ``tests/test_pallas_a2a.py`` runs it), and the
wrapper's rules (CPU tensors take the plain version; CUDA tensors launch
the kernel or raise)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from niwqg_tpu.parallel.mesh import AXIS, make_mesh  # noqa: E402
from niwqg_tpu.parallel import pallas_a2a as jk2  # noqa: E402
from niwqg_tpu_torch.parallel import a2a  # noqa: E402

NDEV = 4


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < NDEV:
        pytest.skip("needs >= 4 devices")
    return make_mesh(NDEV)


def _blocks(z, axis):
    """The NDEV local blocks of a global array cut along ``axis``."""
    return [torch.as_tensor(np.ascontiguousarray(b))
            for b in np.split(z, NDEV, axis=axis)]


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_fwd_ref_matches_jax_kernel(mesh, chunks, lead):
    """Row-sharded (ny, nx) in, column-sharded out: the plain version on
    the list of local blocks equals the JAX kernel, bit for bit."""
    rng = np.random.default_rng(10 + chunks + len(lead))
    ny, nx = 32, 64
    z = (rng.standard_normal(lead + (ny, nx))
         + 1j * rng.standard_normal(lead + (ny, nx)))
    r = len(lead)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda x: jk2.all_to_all_fwd(x, NDEV, chunks=chunks, interpret=True),
        mesh=mesh, in_specs=P(*([None] * r + [AXIS, None])),
        out_specs=P(*([None] * r + [None, AXIS])), check_vma=False))(z))
    got = a2a.all_to_all_fwd_ref(_blocks(z, axis=-2))
    # rank d's (..., ny, nx/NDEV) pencil is column block d of the result
    assert np.array_equal(np.concatenate([g.numpy() for g in got], axis=-1),
                          want)
    # the wrapper on host tensors takes the plain version
    n = a2a.FAMILY.plain_calls("fwd")
    group = a2a.PeerGroup.local(["cpu"] * NDEV)
    via = a2a.all_to_all_fwd(_blocks(z, axis=-2), group, chunks=chunks)
    assert a2a.FAMILY.plain_calls("fwd") == n + 1
    assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_inv_ref_matches_jax_kernel(mesh, chunks, lead):
    rng = np.random.default_rng(20 + chunks + len(lead))
    ny, nx = 64, 32
    z = (rng.standard_normal(lead + (ny, nx))
         + 1j * rng.standard_normal(lead + (ny, nx)))
    r = len(lead)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda x: jk2.all_to_all_inv(x, NDEV, chunks=chunks, interpret=True),
        mesh=mesh, in_specs=P(*([None] * r + [None, AXIS])),
        out_specs=P(*([None] * r + [AXIS, None])), check_vma=False))(z))
    got = a2a.all_to_all_inv_ref(_blocks(z, axis=-1))
    assert np.array_equal(np.concatenate([g.numpy() for g in got], axis=-2),
                          want)
    n = a2a.FAMILY.plain_calls("inv")
    group = a2a.PeerGroup.local(["cpu"] * NDEV)
    via = a2a.all_to_all_inv(_blocks(z, axis=-1), group, chunks=chunks)
    assert a2a.FAMILY.plain_calls("inv") == n + 1
    assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("shape", [(24, 80), (3, 8, 20), (2, 3, 4, 12)])
def test_ref_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    blocks = [torch.as_tensor(rng.standard_normal(shape)
                              + 1j * rng.standard_normal(shape))
              for _ in range(NDEV)]
    fwd = a2a.all_to_all_fwd_ref(blocks)
    assert fwd[0].shape == shape[:-2] + (NDEV * shape[-2], shape[-1] // NDEV)
    back = a2a.all_to_all_inv_ref(fwd)
    assert all(torch.equal(a, b) for a, b in zip(back, blocks))


@pytest.mark.parametrize("width,asked,got", [(16, 5, 4), (16, 2, 2),
                                             (7, 3, 1), (512, 0, 1),
                                             (20, 64, 20)])
def test_clamp_chunks(width, asked, got):
    assert a2a.clamp_chunks(width, asked) == got


def test_wrapper_refuses_what_the_kernel_does_not_take():
    group = a2a.PeerGroup.local(["cpu"] * NDEV)
    ok = [torch.zeros(8, 16, dtype=torch.complex128) for _ in range(NDEV)]
    with pytest.raises(TypeError, match="complex"):
        a2a.all_to_all_fwd([b.real for b in ok], group)
    with pytest.raises(ValueError, match="split"):
        a2a.all_to_all_fwd([b[:, :15] for b in ok], group)
    with pytest.raises(ValueError, match="holds 4 rank"):
        a2a.all_to_all_fwd(ok[:2], group)
    with pytest.raises(ValueError, match="mesh or a list"):
        a2a.PeerGroup()


class _FakeCudaBlock:
    """What the wrapper reads of a tensor, lying on a card that is not
    there (this host's torch cannot make a CUDA tensor)."""

    def __init__(self, device="cuda:0"):
        self.device = torch.device(device)
        self.dtype = torch.complex64
        self.shape = torch.Size((8, 16))

    def is_complex(self):
        return True

    def dim(self):
        return 2

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


def test_cuda_blocks_launch_the_kernel_or_raise(monkeypatch):
    """No fallback: a block on a card goes to the kernel's library, and
    where that cannot be built (no nvcc here) the call raises; the plain
    version is not taken."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("NVCC", raising=False)
    group = a2a.PeerGroup.local(["cuda:0"] * NDEV)
    n = (a2a.FAMILY.plain_calls("fwd"), a2a.counts()["fwd"])
    with pytest.raises(RuntimeError, match="nvcc"):
        a2a.all_to_all_fwd([_FakeCudaBlock() for _ in range(NDEV)], group)
    assert (a2a.FAMILY.plain_calls("fwd"), a2a.counts()["fwd"]) == n
    # a mix of host and card blocks is refused outright
    with pytest.raises(ValueError, match="unsupported devices"):
        a2a.all_to_all_fwd(
            [_FakeCudaBlock()] + [torch.zeros(8, 16, dtype=torch.complex64)
                                  for _ in range(NDEV - 1)], group)


# -- the kernel's task table --------------------------------------------------
def _apply_tasks(inverse, blocks, chunks):
    """Every rank's launch as its task table describes it, done with tensor
    slicing on bytes; returns every rank's output and how many times each
    of its bytes was written."""
    P = len(blocks)
    shape = blocks[0].shape
    lead = int(np.prod(shape[:-2], dtype=np.int64))
    if inverse:
        R, W = shape[-2] // P, shape[-1]
        out_shape = shape[:-2] + (R, P * W)
    else:
        R, W = shape[-2], shape[-1] // P
        out_shape = shape[:-2] + (P * R, W)
    es = blocks[0].element_size()
    outs = [torch.zeros(out_shape, dtype=blocks[0].dtype) for _ in range(P)]
    out_bytes = [o.view(-1).view(torch.uint8) for o in outs]
    counts = [torch.zeros(o.numel(), dtype=torch.int32) for o in out_bytes]
    metas = []
    for me, z in enumerate(blocks):
        tasks, meta = a2a.task_table(inverse, lead, R, W, P, me, chunks, es)
        metas.append((tasks, meta))
        src_bytes = z.contiguous().view(-1).view(torch.uint8)
        for t in tasks:
            nb = int(t["units"]) * meta["unit"]
            rows = torch.arange(int(t["rows"]))[:, None]
            cols = torch.arange(nb)[None, :]
            si = (int(t["src"]) + rows * meta["in_pitch"] + cols).reshape(-1)
            di = (int(t["dst"]) + rows * meta["out_pitch"] + cols).reshape(-1)
            d = int(t["peer"])
            out_bytes[d][di] = src_bytes[si]
            counts[d][di] += 1
    return outs, counts, metas


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("inverse", [0, 1])
@pytest.mark.parametrize("shape,dtype", [
    ((3, 40, 4 * 16), torch.complex64),      # several fields, W = 16
    ((8, 4 * 20), torch.complex64),          # lead = 1, W = 20: 80-byte rows
    ((2, 70, 4 * 128), torch.complex64),     # rows in several task groups
    ((5, 4 * 21), torch.complex64),          # W = 21: the ragged path
    ((2, 3, 4 * 6), torch.complex64),        # W = 6, 24-byte chunks: ragged
    ((2, 6, 4 * 8), torch.complex128),
    ((3, 4 * 512), torch.complex128),        # a segment in several pieces
])
def test_task_table_covers_every_element_once(shape, dtype, inverse, chunks):
    """The table the wrapper hands the kernel, applied by slicing: every
    byte of every rank's output is written exactly once, and the result is
    the plain version's (offsets and pitches are right)."""
    if inverse:  # the inverse takes the forward's output shape
        shape = shape[:-2] + (NDEV * shape[-2], shape[-1] // NDEV)
    rng = np.random.default_rng(len(shape) + shape[-1] + chunks)
    blocks = [torch.as_tensor(rng.standard_normal(shape)
                              + 1j * rng.standard_normal(shape)).to(dtype)
              for _ in range(NDEV)]
    outs, counts, metas = _apply_tasks(inverse, blocks, chunks)
    ref = a2a.all_to_all_inv_ref if inverse else a2a.all_to_all_fwd_ref
    want = ref(blocks)
    for d in range(NDEV):
        assert torch.equal(counts[d], torch.ones_like(counts[d]))
        assert torch.equal(outs[d], want[d])
    for tasks, meta in metas:
        assert (tasks["units"] <= a2a.MAX_UNITS).all()
        assert (tasks["rows"] >= 1).all() and (tasks["units"] >= 1).all()
        assert (tasks["src"] % meta["unit"] == 0).all()
        assert (tasks["dst"] % meta["unit"] == 0).all()
        # neighbouring tasks, taken by neighbouring blocks, change rank
        assert (np.diff(tasks["peer"]) != 0).all()
        assert len(tasks) == NDEV * meta["per_peer"]
        assert all((tasks["peer"] == d).sum() == meta["per_peer"]
                   for d in range(NDEV))


@pytest.mark.parametrize("width,chunks,itemsize,want", [
    (512, 2, 8, "aligned"),     # the sharded flagship: 2 KB segments
    (512, 1, 8, "aligned"),
    (257, 2, 8, "ragged"),      # 257 has no divisor 2: one 2056-byte chunk
    (21, 2, 8, "ragged"),       # W = 21 complex64
    (20, 2, 8, "aligned"),      # two chunks of 10: 80 bytes
    (6, 2, 8, "ragged"),        # two chunks of 3: 24 bytes
    (21, 1, 16, "aligned"),     # complex128 is always whole units
    (1, 4, 8, "ragged"),
])
def test_path_by_shape(width, chunks, itemsize, want):
    assert a2a.path(width, chunks, itemsize) == want


def test_flagship_table():
    """The sharded flagship's forward launch: 2 KB segments, one trip of
    the kernel's block (16 warps x 2 rows) a task, 384 tasks."""
    tasks, meta = a2a.task_table(0, 3, 512, 512, NDEV, 1, 2, 8)
    assert meta["path"] == "aligned" and meta["per_peer"] == 96
    assert (tasks["units"] == 128).all() and (tasks["rows"] == 32).all()
    assert list(tasks["peer"][:NDEV]) == [1, 2, 3, 0]  # starts at me
    assert meta["in_pitch"] == NDEV * 512 * 8 and meta["out_pitch"] == 512 * 8


# -- the mesh's in-step exchanges on the same kernel ---------------------------
@pytest.mark.parametrize("P", [2, 4, 5])
@pytest.mark.parametrize("shape,dtype", [
    ((8, 2 * 64), torch.complex64),          # aligned, one piece a row
    ((16, 3 * 256), torch.complex64),        # 6 KB rows in pieces
    ((5, 7), torch.complex64),               # 56-byte rows: the ragged path
    ((1, 33), torch.complex128),             # one row: only the first goes
])
def test_reflect_table_is_the_plain_exchange(shape, dtype, P):
    """``reflect_table`` applied by slicing on bytes: every rank's output
    written exactly once, equal to ``reflect_exchange_ref`` (row 0 from
    rank (P - r) % P, the others from rank P - 1 - r); each rank receives
    from exactly the ranks it sends to (``recv_counts``)."""
    W, L = shape
    rng = np.random.default_rng(W * L + P)
    sends = [torch.as_tensor(rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)).to(dtype)
             for _ in range(P)]
    es = sends[0].element_size()
    outs = [torch.zeros(shape, dtype=dtype) for _ in range(P)]
    out_bytes = [o.view(-1).view(torch.uint8) for o in outs]
    counts = [torch.zeros(o.numel(), dtype=torch.int32) for o in out_bytes]
    table = lambda r: a2a.reflect_table(W, L, P, r, es)
    for me, z in enumerate(sends):
        tasks, meta = table(me)
        assert (tasks["units"] <= a2a.MAX_UNITS).all()
        src = z.view(-1).view(torch.uint8)
        for t in tasks:
            nb = int(t["units"]) * meta["unit"]
            rows = torch.arange(int(t["rows"]))[:, None]
            cols = torch.arange(nb)[None, :]
            si = (int(t["src"]) + rows * meta["in_pitch"] + cols).reshape(-1)
            di = (int(t["dst"]) + rows * meta["out_pitch"] + cols).reshape(-1)
            out_bytes[int(t["peer"])][di] = src[si]
            counts[int(t["peer"])][di] += 1
        recv = a2a.recv_counts(table, P, me)
        sent = [int((tasks["peer"] == d).sum()) for d in range(P)]
        assert [r > 0 for r in recv] == [s > 0 for s in sent]
    want = a2a.reflect_exchange_ref(sends)
    for d in range(P):
        assert torch.equal(counts[d], torch.ones_like(counts[d]))
        assert torch.equal(outs[d], want[d])


def test_plain_all_reduce_of_a_local_group():
    """The plain version of ``all_reduce`` on a one-process group: every
    rank gets the rank-order sum (or maximum) of every rank's tensor."""
    group = a2a.PeerGroup.local(["cpu"] * NDEV)
    rng = np.random.default_rng(3)
    ts = [torch.as_tensor(rng.standard_normal((2, 3))) for _ in range(NDEV)]
    calls = a2a.FAMILY.plain_calls("gather")
    for op, fold in (("sum", torch.add), ("max", torch.maximum)):
        want = ts[0]
        for t in ts[1:]:
            want = fold(want, t)
        got = a2a.all_reduce(ts, group, op)
        assert len(got) == NDEV and all(torch.equal(g, want) for g in got)
    assert a2a.FAMILY.plain_calls("gather") == calls + 2
    with pytest.raises(ValueError, match="'sum' or 'max'"):
        a2a.all_reduce(ts, group, "min")
