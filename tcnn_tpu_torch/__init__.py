"""tcnn_tpu_torch - the PyTorch/CUDA port of tcnn_tpu for NVIDIA Hopper.

Imports `torch` and never `jax`. Uses the JAX package's JSON "otype"
configs, flat parameter layout ([network | encoding]) and checkpoint format.
So far it trains and serves grid, PPNG1/2/3, fixed-function (Identity,
Frequency, TriangleWave, OneBlob, SphericalHarmonics, Empty) and Composite
encodings + MLP models with the nine losses and every optimizer of the JAX
package (Adam, SGD, Novograd, Shampoo, the EMA, Average, Lookahead,
Batched and ExponentialDecay wrappers, Composite), in bf16 or, with the
Trainer's `compute_dtype=torch.float32`, in f32, through the Trainer
or the module API (`NetworkWithInputEncoding`, `Network`, `Encoding`:
`torch.nn.Module`s with `fwd` / `bwd`), and differentiates them with
respect to their inputs to second order (`model.apply(...,
prepare_input_gradients=True)`, then `torch.autograd.grad(...,
create_graph=True)`; the eikonal SDF sample, `python -m
tcnn_tpu_torch.samples.learn_a_sdf [encoding_otype]`). Thirteen
hand-written CUDA kernels for sm_90a under ``csrc/`` carry those paths:
grid forward (K1), backward (K4), backward with input gradients (K7) and
double backward (K8); fully fused MLP forward (K2) and backward (K5); fused
grid + MLP inference (K3), train step (K6) and input-gradient backward
(K9); the PPNG tables' row gather (K10), its scatter (K11), weighted lookup
(K12) and the lookup's backward (K13). They build at first use on a CUDA
tensor; a CPU tensor takes each kernel's plain PyTorch twin.
Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`). A config with instant-ngp's "dir_encoding" and
"rgb_network" blocks (its configs/nerf/base.json) builds instant-ngp's NeRF
(`models.nerf.NerfNetwork`), trained on rays (`ops.volume.Rays`).

Around the model: `parallel` trains data-parallel on `torch.distributed`
(`DataParallelTrainer`, `init_distributed`, `dryrun_multichip`), `native`
generates the reference demo's PCG32 batches on the host (`HostRng`, a g++
library built at first use, with a numpy fallback), and
`utils.profiling` times steps (`StepTimer`) and traces them (`trace`).
"""

__version__ = "0.1.0"

from .common import (  # noqa: F401
    Activation,
    BATCH_SIZE_GRANULARITY,
    GradientMode,
    GridType,
    HashType,
    InterpolationType,
    ReductionType,
    default_loss_scale,
)
from .config import (  # noqa: F401
    TrainableModel,
    create_from_config,
    create_network_with_input_encoding,
    load_config,
)
from .log import (  # noqa: F401
    LogSeverity,
    log,
    log_debug,
    log_error,
    log_info,
    log_success,
    log_warning,
    set_log_callback,
    set_verbose,
)
from .models.mlp import CutlassMLP, FullyFusedMLP  # noqa: F401
from .modules import Encoding, Network, NetworkWithInputEncoding  # noqa: F401
from .ops.encodings.grid import GridEncoding  # noqa: F401
from .ops.encodings.ppng import (  # noqa: F401
    PPNG1Encoding,
    PPNG2Encoding,
    PPNG3Encoding,
    PPNGBase,
)
from .ops.losses import Loss  # noqa: F401
from .optimizers.adam import AdamOptimizer  # noqa: F401
from .registry import (  # noqa: F401
    create_encoding,
    create_loss,
    create_network,
    create_optimizer,
    register_encoding,
    register_loss,
    register_network,
    register_optimizer,
)
from .trainer import Trainer  # noqa: F401
from .utils.serialization import opt_state_from_jax, params_from_jax  # noqa: F401

batch_size_granularity = BATCH_SIZE_GRANULARITY  # the reference binding's name
