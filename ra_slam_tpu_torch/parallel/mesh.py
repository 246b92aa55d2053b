"""Shard meshes and their collectives (the port's counterpart of a 1-D
`jax.sharding.Mesh` and of the `jax.lax` collectives that the JAX
package's `shard_map` bodies call).

A body is written once, as `body(ctx, *shard_args)`, against the
`ShardContext` it is given: `ctx.index` (`axis_index`), `ctx.size`,
`psum`, `all_gather` (tiled on dim 0), `psum_scatter` (tiled on dim 0)
and `ppermute`. `mesh.run(body, *sharded)` calls it once for every shard
held in this process, shard arguments taken from per-shard lists, and
returns the per-shard results as a list. Two meshes implement it:

  LocalMesh(n, device)   n shards in one process, on one device: the
                         counterpart of a single-process mesh over n
                         devices, and the only multi-shard form one GPU
                         can run (NCCL refuses two ranks on one GPU).
  ProcessGroupMesh()     one shard per process over `torch.distributed`:
                         NCCL when the process's device is a GPU, gloo
                         on the CPU.

Every collective's result is computed from the shards' values in shard
order 0..n-1 (a sum is ((x0 + x1) + x2) + ...), so no result depends on
thread timing or on the backend's reduction order, and the two meshes
give the same bits for the same shard values.

LocalMesh steps its n bodies together, one thread each: a body calls
collectives between local passes, so shards cannot run one after
another. The threads take turns in shard order, each running until its
next collective, and the last to arrive computes it; so one thread runs
at a time (no contention for the interpreter lock), all of them enqueue
on the device's current stream in a fixed order, and a shard reads
another's tensor only after the kernels that produce it were queued. A
shard that raises stops the others at their next turn and `run`
re-raises its error. Every wait has a timeout, so a lost shard fails the
call instead of hanging it.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, List, Sequence

import torch

from ra_slam_tpu_torch.core.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def _ordered_sum(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    return functools.reduce(torch.add, vals)


def _chunk(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    c = x.shape[0] // n
    return x[i * c:(i + 1) * c]


def _source(perm, dst: int):
    src = [s for s, d in perm if d == dst]
    return src[0] if src else None


class ShardContext:
    """One shard's view of the mesh inside a body."""

    def __init__(self, mesh, index: int, exchange: Callable):
        self.mesh = mesh
        self.axis = mesh.axis
        self.index = index
        self.size = mesh.size
        # exchange(x, op) -> op(values of every shard in order)[index]
        self._exchange = exchange

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The shards' `x` concatenated on dim 0 in shard order."""
        return self._exchange(x, lambda vals: [torch.cat(vals, 0)] * len(vals))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the shards' `x`, added in shard order."""
        return self._exchange(x, lambda vals: [_ordered_sum(vals)] * len(vals))

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk `index` (of `size` equal chunks of dim 0) of the sum of
        the shards' `x`, added in shard order."""
        n = self.size
        return self._exchange(
            x, lambda vals: [_ordered_sum([_chunk(v, i, n) for v in vals]) for i in range(n)]
        )

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """The `x` of the shard `s` with (s, index) in `perm`, zeros if
        no shard sends here."""
        def op(vals):
            out = []
            for i in range(len(vals)):
                s = _source(perm, i)
                out.append(torch.zeros_like(vals[i]) if s is None else vals[s].clone())
            return out

        return self._exchange(x, op)


class LocalMesh:
    """n shards in this process on one device, stepped together."""

    def __init__(self, n: int, device="cuda", axis: str = "map", timeout: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        self.size = int(n)
        self.device = resolve_device(device)
        self.axis = axis
        self.timeout = timeout

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def local_shards(self) -> List[int]:
        return list(range(self.size))

    def __repr__(self) -> str:
        return f"LocalMesh({self.size}, {self.device}, axis={self.axis!r})"

    def all_shards(self, local: list) -> list:
        """Per-shard values of every shard (all of them are local)."""
        return list(local)

    def run(self, body, *sharded) -> list:
        n = self.size
        args = [[s[i] for s in sharded] for i in range(n)]
        if n == 1:
            return [body(ShardContext(self, 0, lambda x, op: op([x])[0]), *args[0])]
        turns = _Turns(n, self.timeout)
        results: list = [None] * n

        def work(i):
            ctx = ShardContext(self, i, functools.partial(turns.exchange, i))
            try:
                turns.wait(i)
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        results[i] = body(ctx, *args[i])
                else:
                    results[i] = body(ctx, *args[i])
                turns.finish(i)
            except BaseException as e:  # noqa: BLE001 - re-raised by run
                turns.fail(i, e)

        threads = [threading.Thread(target=work, args=(i,), name=f"{self.axis}-shard-{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        if any(t.is_alive() for t in threads):
            turns.fail(None, TimeoutError(f"{self}: a shard did not finish within {self.timeout} s"))
        if turns.error is not None:
            raise turns.error
        return results


class _ShardFailed(Exception):
    """Raised in the other shards' threads when one shard fails."""


class _Turns:
    """The shards of a LocalMesh take turns in shard order, each running
    until its next collective (or its end): one thread runs at a time,
    so the shards do not contend for the interpreter lock, and the
    order of every device enqueue is fixed. The last shard to arrive at
    a collective computes it from every shard's value."""

    def __init__(self, n: int, timeout: float):
        self.n, self.timeout = n, timeout
        self.cv = threading.Condition()
        self.turn = 0
        self.finished = [False] * n
        self.slots, self.ops = [None] * n, [None] * n
        self.results = None
        self.error = None

    def wait(self, i: int) -> None:
        with self.cv:
            if not self.cv.wait_for(lambda: self.turn == i or self.error is not None, self.timeout):
                self.error = self.error or TimeoutError(f"shard {i} waited {self.timeout} s for its turn")
                self.cv.notify_all()
            if self.error is not None:
                raise _ShardFailed()

    def _pass(self, i: int) -> None:
        with self.cv:
            self.turn = (i + 1) % self.n
            self.cv.notify_all()

    def exchange(self, i: int, x, op):
        """Shard i's value for the current collective: the collective's
        result for shard i, once every shard has given its value."""
        if any(self.finished):
            raise RuntimeError("the shards of a LocalMesh called different numbers of collectives")
        self.slots[i], self.ops[i] = x, op
        if i == self.n - 1:
            if len({o.__code__ for o in self.ops}) != 1:
                raise RuntimeError("the shards of a LocalMesh called different collectives at one step")
            self.results = op(list(self.slots))
        self._pass(i)
        self.wait(i)
        return self.results[i]

    def finish(self, i: int) -> None:
        self.finished[i] = True
        self._pass(i)

    def fail(self, i, e: BaseException) -> None:
        with self.cv:
            if self.error is None and not isinstance(e, _ShardFailed):
                self.error = e
            self.cv.notify_all()


class ProcessGroupMesh:
    """One shard per process of the default `torch.distributed` group
    (NCCL on `cuda:<current device>`, gloo on the CPU)."""

    def __init__(self, axis: str = "map"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs torch.distributed.init_process_group first")
        self._dist = dist
        self.axis = axis
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        backend = dist.get_backend()
        self.device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                       else torch.device("cpu"))

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def local_shards(self) -> List[int]:
        return [self.rank]

    def __repr__(self) -> str:
        return f"ProcessGroupMesh({self.size}, rank {self.rank}, {self.device}, axis={self.axis!r})"

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every process's `x` (one shape on all), in rank order."""
        flat = x.reshape(-1)
        wire = flat.view(torch.uint8) if flat.dtype == torch.bool else flat
        bufs = [torch.empty_like(wire) for _ in range(self.size)]
        self._dist.all_gather(bufs, wire.contiguous())
        if flat.dtype == torch.bool:
            bufs = [b.view(torch.bool) for b in bufs]
        return [b.reshape(x.shape) for b in bufs]

    def _exchange(self, x, op):
        return op(self._gather(x))[self.rank]

    def _ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        dist = self._dist
        dst = [d for s, d in perm if s == self.rank]
        src = _source(perm, self.rank)
        if dst and dst[0] == self.rank:
            return x.clone()
        out = torch.zeros_like(x)
        reqs = []
        if dst:
            reqs.append(dist.isend(x.contiguous(), dst[0]))
        if src is not None:
            reqs.append(dist.irecv(out, src))
        for r in reqs:
            r.wait()
        return out

    def all_shards(self, local: list) -> list:
        """Per-shard values of every shard, from every process (the
        values are pickled: numpy arrays and host scalars)."""
        got = [None] * self.size
        self._dist.all_gather_object(got, local[0])
        return got

    def run(self, body, *sharded) -> list:
        return [body(_ProcessGroupContext(self), *[s[0] for s in sharded])]


class _ProcessGroupContext(ShardContext):
    """A process's shard: collectives through the process group; the
    permutation point to point instead of through a gather."""

    def __init__(self, mesh: ProcessGroupMesh):
        super().__init__(mesh, mesh.rank, mesh._exchange)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        return self.mesh._ppermute(x, perm)
