// K9 (the fused input-gradient backward) at F = 1 features per level: its kernels and
// their launch (fused_train.cuh), compiled apart from the other F so
// that nvcc builds them in parallel; its entry points are in fused_ig.cu.
#include "fused_train.cuh"

TCNN_TRAIN_INSTANCE(, 1, true)
