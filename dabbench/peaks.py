"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W), the yardstick of every roofline share."""

#: device memory bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
#: add-compare-select operations a second: the integer ALU rate the
#: port's Viterbi kernels are held to (PERF.md's kernel table)
ACS_OPS_S = 33.5e12
#: host-to-device bytes/s over the card's host link: PCIe Gen5 x16,
#: which the H100 SXM data sheet gives as 128 GB/s counting both ways
PCIE_H2D_BYTES_S = 64e9
