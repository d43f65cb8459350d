"""The rate of the 1-bit AND + POPC tensor-core MMA on one NVIDIA H100
SXM (mma.sync.m16n8k256.b1.and.popc, SASS BMMA.168256.AND.POPC), in the
operations the rooflines count: 64 a pair of 32-bit words (an AND and
an add of each bit).

NVIDIA's data sheet gives no peak for this instruction, so the rate is
the highest the port's own probe measured (tomahawk_tpu_torch/csrc/
mma_probe.cu: 10.2-10.5e15 on an H100 80GB HBM3 at 700 W). The highest
makes the least time shortest, so a share against it is the lower one."""

#: bit-operations a second
B1_OPS_PER_S = 10.5e15
