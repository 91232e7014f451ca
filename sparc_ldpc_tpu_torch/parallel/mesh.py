"""Device mesh and sharding policy (port of sparc_ldpc_tpu/parallel/mesh.py).

Axes, as in the reference:
  data    — the Monte-Carlo codeword batch; only the error counters
            cross it.
  section — the SPARC sections (the L axis of each codeword's (L, M)
            tile), sharded by whole sections, so the sectionwise softmax
            stays local and only the per-iteration scalars |z|^2, |beta|^2
            and the transform's cross-shard stages cross it
            (parallel/amp_sharded.py, parallel/dist_fwht.py).

A mesh is a (D, S) arrangement of torch devices that one process drives
(the reference is single-controller too: one process drives its host's
devices).  The port has no partitioner: the sharded paths cut a tensor
over the mesh themselves (`ShardingPolicy.split_data`,
`ShardingPolicy.split_sections`), run each piece on its device, and
gather the results on the mesh's first device, `home`, where the model's
constants, the draws and the counters live.  A device may appear more
than once: a *virtual mesh* such as `["cpu"] * 8` or `[cuda:0] * 4` runs
the code of a multi-GPU node on one device (the counterpart of the 8 fake
CPU devices the reference's tests give JAX).

Across processes (torch.distributed, the CLI's `--distributed`) each
process holds its own mesh of D x S_local devices.  The section axis may
span processes as well: a *section group* of G consecutive ranks holds
the S = G S_local slabs of one data group, rank q of the group slabs
[q S_local, (q + 1) S_local), and the ranks of a group decode the same
rows.  The rows of every block are split over the data groups
(`process_rows`), then over each process's D data shards.  A group's
ranks exchange slabs with `torch.distributed` point to point
(`exchange`, the hypercube stages of parallel/dist_fwht.py) and gather
per-codeword sums and beta in shard order (`gather_sections`), over a
process group of their own (`section_group`): NCCL between GPUs, or
gloo, whose CUDA tensors cross through host memory.  The counters are
summed over the data groups at each harvest, as a CPU tensor, over the
default process group (gloo).  Copies between two devices of a real
multi-GPU mesh are `Tensor.to`, which PyTorch orders after the producer
on the source device's current stream and before the consumer on the
destination's; the multi-GPU cases of tests/test_torch_cuda.py hold real
meshes of several GPUs to the same meshes made virtual on one, bit for
bit.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..utils.profiling import annotate, count, group, interval, tracing


@dataclass(frozen=True)
class Mesh:
    """A (data, section) grid of torch devices; row d holds the S devices
    of data shard d, and devices[0][0] is the home device."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(section_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over `devices` (default: every visible CUDA device), data x
    section, with D = len(devices) / section_shards; device i sits at
    (i // S, i % S).  Devices may repeat (a virtual mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 8) for a mesh of CPU "
                               "devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n, S = len(devices), section_shards
    if S < 1 or n == 0 or n % S:
        raise ValueError(f"{n} devices not divisible by section_shards={S}")
    return Mesh(tuple(tuple(devices[d * S:(d + 1) * S])
                      for d in range(n // S)))


# The section exchange's cost in this process (`exchange` and
# `gather_sections`): calls, bytes sent, and host seconds from the
# synchronized start of each to its received tensors on their devices; a
# group of the tracing registry (utils/profiling.py) that counts in every
# run, traced or not.
EXCHANGE_STATS = group("mesh.exchange", calls=0, bytes=0, s=0.0)


def section_groups(section_procs: int, backend: str):
    """Every section group's process group, G = section_procs consecutive
    ranks each (every rank creates every group, in order, as
    torch.distributed asks); this rank's."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if world % section_procs:
        raise ValueError(f"{world} processes do not make section groups of "
                         f"{section_procs}")
    mine = None
    for g in range(world // section_procs):
        ranks = list(range(g * section_procs, (g + 1) * section_procs))
        pg = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mine = pg
    return mine


@dataclass(frozen=True)
class ShardingPolicy:
    """The mesh of this process, and this process's place among `world`
    processes (rank 0 of 1 without torch.distributed).

    Passed to the model builders, `amp_decode` and the campaign.  With
    section_procs G > 1 the section axis spans the G consecutive ranks of
    this rank's section group (`section_group`, a torch.distributed
    process group), each holding the mesh's S_local slabs.  A block of B
    rows is split first over the world / G data groups (`process_rows`),
    then over the data shards of the mesh (`split_data`); B must be
    divisible by (world / G) * D (`check_batch`)."""
    mesh: Mesh
    rank: int = 0
    world: int = 1
    section_procs: int = 1
    section_group: Optional[object] = field(default=None, compare=False)

    @staticmethod
    def for_process(mesh: Mesh, section_procs: int = 1,
                    backend: str = "gloo") -> "ShardingPolicy":
        """The policy of this process: rank and world size from the default
        torch.distributed process group when one is initialized, and with
        section_procs > 1 the section groups over `backend`."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            if section_procs != 1:
                raise ValueError("a section axis across processes needs "
                                 "torch.distributed")
            return ShardingPolicy(mesh)
        group = (section_groups(section_procs, backend)
                 if section_procs > 1 else None)
        return ShardingPolicy(mesh, dist.get_rank(), dist.get_world_size(),
                              section_procs, group)

    @property
    def data_shards(self) -> int:
        return self.mesh.shape[0]

    @property
    def section_shards(self) -> int:
        """S, the slabs of the whole section axis (across the section
        group's processes).  1 is pure DP: each codeword's (L, M) state
        lives whole on one device, which the in-kernel encode and noise
        need."""
        return self.mesh.shape[1] * self.section_procs

    @property
    def section_rank(self) -> int:
        """This rank's place q in its section group."""
        return self.rank % self.section_procs

    @property
    def data_groups(self) -> int:
        return self.world // self.section_procs

    @property
    def home(self) -> torch.device:
        return self.mesh.home

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each data shard."""
        return [row[0] for row in self.mesh.devices]

    @property
    def is_writer(self) -> bool:
        """Only rank 0 writes results and the journal."""
        return self.rank == 0

    def check_batch(self, batch: int) -> None:
        shards = self.data_groups * self.data_shards
        if batch % shards:
            raise ValueError(f"batch {batch} is not divisible by the "
                             f"{self.data_groups} data group(s) of processes"
                             f" x {self.data_shards} data shard(s)")

    def process_rows(self, batch: int) -> slice:
        """This process's rows of a block of `batch` rows: its data
        group's (the ranks of a section group decode the same rows)."""
        self.check_batch(batch)
        per = batch // self.data_groups
        g = self.rank // self.section_procs
        return slice(g * per, (g + 1) * per)

    def own_rows(self, *xs: Optional[torch.Tensor]
                 ) -> List[Optional[torch.Tensor]]:
        """This process's rows of each of a block's draws xs (None stays
        None)."""
        rows = self.process_rows(xs[0].shape[0])
        return [None if x is None else x[rows] for x in xs]

    def split_data(self, x: Optional[torch.Tensor]
                   ) -> List[Optional[torch.Tensor]]:
        """x cut into D equal slices along dim 0, slice d on data shard d's
        first device (None stays None)."""
        D = self.data_shards
        if x is None:
            return [None] * D
        if x.shape[0] % D:
            raise ValueError(f"{x.shape[0]} rows are not divisible by {D} "
                             f"data shards")
        return [p.to(dev) for p, dev in
                zip(torch.chunk(x, D, 0), self.data_devices)]

    def stage(self, fn: Callable[[torch.device], Any]) -> List[Any]:
        """fn(dev) for each data shard's first device, in shard order: a
        data mesh's per-card inputs, staged before the first shard's work
        is queued.  A copy between two cards runs on the source card's
        stream behind the work queued on both, so a copy queued after the
        home card's launch would hold its card until that launch ends.
        While tracing, each call but the home shard's runs in a
        `mesh.shard_inputs` interval on its device's stream: the time that
        card waits for the home card's work queued before these copies."""
        out = []
        for d, dev in enumerate(self.data_devices):
            with (interval("mesh.shard_inputs", dev) if d
                  else contextlib.nullcontext()):
                out.append(fn(dev))
        return out

    def split_sections(self, x: Optional[torch.Tensor], d: int, dim: int
                       ) -> List[Optional[torch.Tensor]]:
        """This process's slabs of x: x cut into S contiguous slabs along
        dim (the L axis), slab q S_local + s contiguous on device (d, s)
        (None stays None)."""
        S, k = self.section_shards, self.mesh.shape[1]
        if x is None:
            return [None] * k
        if x.shape[dim] % S:
            raise ValueError(f"{x.shape[dim]} sections are not divisible "
                             f"by {S} section shards")
        q = self.section_rank
        return [p.to(dev).contiguous() for p, dev in
                zip(torch.chunk(x, S, dim)[q * k:(q + 1) * k],
                    self.mesh.devices[d])]

    # ------------------------------------------- the section group's traffic

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """t as the section group's backend takes it: gloo gets a CPU copy
        of a CUDA tensor (the slabs cross through host memory)."""
        if t.is_cuda and self._backend() == "gloo":
            return t.cpu()
        return t.contiguous()

    def _backend(self) -> str:
        import torch.distributed as dist

        return str(dist.get_backend(self.section_group))

    def _timed(self, tensors: Sequence[torch.Tensor], fn):
        """fn() timed into EXCHANGE_STATS, from a synchronized start to its
        results on their devices."""
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        EXCHANGE_STATS["calls"] += 1
        EXCHANGE_STATS["bytes"] += sum(t.numel() * t.element_size()
                                       for t in tensors)
        EXCHANGE_STATS["s"] += time.perf_counter() - t0
        return out

    def exchange(self, parts: Sequence[torch.Tensor], partner: int
                 ) -> List[torch.Tensor]:
        """Send parts to rank `partner` of the section group and receive
        its parts of the same shapes, both directions posted together
        (`torch.distributed.batch_isend_irecv`); each received tensor on
        the device and in the memory layout of the part it pairs with (as
        a partner slab inside one process has it: an operation's rounding
        may follow its operands' layout)."""
        import torch.distributed as dist

        peer = (self.rank // self.section_procs) * self.section_procs \
            + partner

        def run():
            sends = [self._staged(p) for p in parts]
            recvs = [torch.empty_like(s) for s in sends]
            ops = [dist.P2POp(dist.isend, s, peer, self.section_group)
                   for s in sends]
            ops += [dist.P2POp(dist.irecv, r, peer, self.section_group)
                    for r in recvs]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return [torch.empty_like(p).copy_(r) for r, p in zip(recvs, parts)]

        return self._timed(parts, run)

    def gather_sections(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The section group's tensors t (one a rank, the same shape)
        concatenated along dim in shard order, on t's device; t itself
        when the group is this process."""
        if self.section_procs == 1:
            return t
        import torch.distributed as dist

        def run():
            s = self._staged(t)
            parts = [torch.empty_like(s) for _ in range(self.section_procs)]
            dist.all_gather(parts, s, group=self.section_group)
            return torch.cat(parts, dim).to(t.device)

        return self._timed([t], run)

    def gather(self, parts: Sequence[torch.Tensor], dim: int
               ) -> torch.Tensor:
        """The parts concatenated along dim on the home device; while
        tracing, the bytes of every part but the first (the home shard's)
        count into `mesh.gather_bytes`."""
        with annotate("mesh.gather"):
            if tracing():
                count("mesh.gather_bytes", sum(
                    p.numel() * p.element_size() for p in parts[1:]))
            if len(parts) == 1:
                return parts[0].to(self.home)
            return torch.cat([p.to(self.home) for p in parts], dim)

    def all_reduce(self, vals: torch.Tensor) -> torch.Tensor:
        """vals, a CPU tensor of this data group's counters, summed over
        the data groups (itself with one process): the ranks of a section
        group hold the same counters, and only its first adds them."""
        if self.world == 1:
            return vals
        import torch.distributed as dist

        out = vals.clone() if self.section_rank == 0 else torch.zeros_like(
            vals)
        dist.all_reduce(out)
        return out

    def broadcast(self, obj):
        """Rank 0's obj on every process."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]
