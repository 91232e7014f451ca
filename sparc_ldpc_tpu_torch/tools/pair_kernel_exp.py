#!/usr/bin/env python3
"""Two codewords per block in the split fused AMP kernel (port of
scripts/pair_kernel_exp.py): does interleaving two codewords' stages
hide one codeword's arithmetic behind the other's loads?

    python -m sparc_ldpc_tpu_torch.tools.pair_kernel_exp [VARIANT ...]
        [--batch 512] [--iters 32] [--cpu]

"pair" is the full decode with two codewords in every row-stage block
(ops/amp_exp.py, csrc/amp_exp.cu: on the card K1's column stage and K1's
row stage at its paired variant, a warp taking a section row of two
codewords, so its bits are full's); "full", one codeword a block, runs
beside it for the comparison.  The sizes, draws and timing are
kernel_ablation.py's (L=1024, M=512, R=1.0, iterative power, 2.0 dB,
bf16, B=512 (even), T=32, median of 5 blocks after a warm one); each line
adds Mbit/s, the block's section errors and the mean final tau2 (of the
first codeword of each pair for "pair").  On the card the `nvidia-smi`
name and power limit are printed beside the numbers; --cpu runs the plain
versions.
"""

from __future__ import annotations

from typing import Dict, List

from sparc_ldpc_tpu_torch.tools.kernel_ablation import main_for

VARIANTS = ("pair", "full")


def main(argv=None) -> List[Dict]:
    return main_for(__doc__, VARIANTS, decodes=True, argv=argv)


if __name__ == "__main__":
    main()
