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

Across processes (torch.distributed, the CLI's `--distributed`) only the
data axis spans processes: each process holds its own (D, S) mesh and
decodes its share of every block's rows (`process_rows`), and the
counters are summed over the processes at each harvest, as a CPU tensor,
over the default process group (gloo).  A section axis across processes is
not ported (ROADMAP A10).  Copies between two devices of a real multi-GPU
mesh are `Tensor.to`, which PyTorch orders after the producer on the
source device's current stream and before the consumer on the
destination's; the multi-GPU cases of tests/test_torch_cuda.py hold real
meshes of several GPUs to the same meshes made virtual on one, bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


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


@dataclass(frozen=True)
class ShardingPolicy:
    """The mesh of this process, and this process's place among `world`
    processes (rank 0 of 1 without torch.distributed).

    Passed to the model builders, `amp_decode` and the campaign.  A block
    of B rows is split first over the processes (`process_rows`), then
    over the data shards of the mesh (`split_data`); B must be divisible
    by world * D (`check_batch`)."""
    mesh: Mesh
    rank: int = 0
    world: int = 1

    @staticmethod
    def for_process(mesh: Mesh) -> "ShardingPolicy":
        """The policy of this process: rank and world size from the default
        torch.distributed process group when one is initialized."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return ShardingPolicy(mesh, dist.get_rank(),
                                  dist.get_world_size())
        return ShardingPolicy(mesh)

    @property
    def data_shards(self) -> int:
        return self.mesh.shape[0]

    @property
    def section_shards(self) -> int:
        """1 is pure DP: each codeword's (L, M) state lives whole on one
        device, which the in-kernel encode and noise need."""
        return self.mesh.shape[1]

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
        shards = self.world * self.data_shards
        if batch % shards:
            raise ValueError(f"batch {batch} is not divisible by the "
                             f"{self.world} process(es) x {self.data_shards} "
                             f"data shard(s)")

    def process_rows(self, batch: int) -> slice:
        """This process's rows of a block of `batch` rows."""
        self.check_batch(batch)
        per = batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

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

    def split_sections(self, x: Optional[torch.Tensor], d: int, dim: int
                       ) -> List[Optional[torch.Tensor]]:
        """x cut into S contiguous slabs along dim (the L axis), slab s
        contiguous on device (d, s) (None stays None)."""
        S = self.section_shards
        if x is None:
            return [None] * S
        if x.shape[dim] % S:
            raise ValueError(f"{x.shape[dim]} sections are not divisible "
                             f"by {S} section shards")
        return [p.to(dev).contiguous() for p, dev in
                zip(torch.chunk(x, S, dim), self.mesh.devices[d])]

    def gather(self, parts: Sequence[torch.Tensor], dim: int
               ) -> torch.Tensor:
        """The parts concatenated along dim on the home device."""
        if len(parts) == 1:
            return parts[0].to(self.home)
        return torch.cat([p.to(self.home) for p in parts], dim)

    def all_reduce(self, vals: torch.Tensor) -> torch.Tensor:
        """vals, a CPU tensor, summed over the processes (itself with one
        process)."""
        if self.world == 1:
            return vals
        import torch.distributed as dist

        out = vals.clone()
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
