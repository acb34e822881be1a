// K6 (the fused train step) at F = 1 features per level: its kernels and
// their launch (fused_train.cuh), compiled apart from the other F so
// that nvcc builds them in parallel; its entry points are in fused_train.cu.
#include "fused_train.cuh"

TCNN_TRAIN_INSTANCE(, 1, false)
