#!/usr/bin/env python3
"""L-axis transform experiments of the split fused AMP kernel (port of
scripts/lstage_exp.py): does another factoring of H_L serve its column
stage better?

    python -m sparc_ldpc_tpu_torch.tools.lstage_exp [VARIANT ...]
        [--batch 512] [--iters 32] [--cpu]

Variants (ops/amp_exp.py, csrc/amp_exp.cu), every one a real decode; on
the card each is K1's encode and row stage with a column stage of its own
on K1's walker (one block an SM over (codeword, strip) items, the next
strip prefetched), H_{f_b} on the tensor cores reading the strip in place:

  slab_loop     H_1024 = H_8 (x) H_128, both on the tensor cores, the
                slabs in a loop
  slab_unroll   the same, the slab loop unrolled
  slab_batched  the same, every slab's products issued before any store
  f512_vpu2     H_1024 = H_2 (x) H_512: H_512 on the tensor cores, H_2 as
                float32 butterflies
  f256_vpu4     H_1024 = H_4 (x) H_256, H_4 butterflies
  f128_vpu8     H_1024 = H_8 (x) H_128, H_8 butterflies
  l256_m128     f256_vpu4, and H_512 = H_4 (x) H_128 along the rows with
                H_128 on the tensor cores

The sizes, draws and timing are kernel_ablation.py's (L=1024, M=512,
R=1.0, iterative power, 2.0 dB, bf16, B=512, T=32, median of 5 blocks
after a warm one); each line adds Mbit/s, the block's section errors and
its mean final tau2, since the variants decode for real.  On the card the
`nvidia-smi` name and power limit are printed beside the numbers; --cpu
runs the plain versions.
"""

from __future__ import annotations

from typing import Dict, List

from sparc_ldpc_tpu_torch.ops.amp_exp import S3_MODES
from sparc_ldpc_tpu_torch.tools.kernel_ablation import main_for


def main(argv=None) -> List[Dict]:
    return main_for(__doc__, S3_MODES, decodes=True, argv=argv)


if __name__ == "__main__":
    main()
