"""The port's input-gradient grid path (K7's and K8's twins) at a table size
where tcnn_tpu takes its binned route (B12: `grid_encode_split_ig`, whose
binned levels run `_combine_ig_kernel` for dL/dx and
`_combine_bwdbwd_kernel` for the double backward, Pallas in interpret
mode), on the CPU: first order (table gradient and dL/dx) and second order
(the vjp of that vjp for a table cotangent and a dL/dx cotangent z), as
tests/test_binned_kernel.py:327-425 drives the binned route. 2-D Linear on
a two-level T=2^14 grid here (base resolution 128: level 0 on the dense
Pallas kernels, level 1 binned, so the prefix's and the suffix's input
gradients add); 3-D Smoothstep (whose second derivative enters the double
backward) on a one-level binned grid (base resolution 32). x inside
[0.05, 0.95], where the JAX input-gradient kernels agree with the XLA
oracle; no pick dropped (asserted).

Tolerances (norm-relative per output), tests/test_torch_grid_ig.py's
against the dense Pallas route, except where the binned scatter rounds a
slot's f32 sum to bf16 again (binned_kernel.py:1127-1142): the table
gradients of both orders take BINNED_GRAD_REL = 1e-3 (readings 5.7e-5 to
1.2e-4 on test_binned_kernel.py's 5-level grid); dL/dx and ct_x 1e-5 (the
same bf16 features times the same f32 dW/dx, summed in another order;
readings 6.1e-7 and 7.8e-8); ct_gy, which the JAX package returns in bf16,
1e-5 after the same rounding (reading: bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnn_tpu.ops.pallas import binned_kernel as bk
from tcnn_tpu_torch.ops.cuda import grid_kernel
from test_torch_binned import BINNED_GRAD_REL, enc_cfg, pair, rel

IG_REL = 1e-5


def jax_ig(split, p, x, gy, z, ct):
    """(dropped picks, [gparams, gx], [ct_params, ct_x, ct_gy]) of
    `grid_encode_split_ig`'s vjp and the vjp of that vjp."""

    def bwd(pp, xx, gg):
        y, vjp = jax.vjp(lambda a, b: bk.grid_encode_split_ig(split, a, b), pp, xx)
        return vjp(gg.astype(y.dtype))

    with pltpu.force_tpu_interpret_mode():
        drops = bk.count_drops(split, jnp.asarray(x))
        first, vjp2 = jax.vjp(bwd, jnp.asarray(p), jnp.asarray(x), jnp.asarray(gy))
        second = vjp2((jnp.asarray(ct), jnp.asarray(z)))
    return drops, [np.asarray(t, np.float32) for t in first], [np.asarray(t, np.float32)
                                                                for t in second]


def port_ig(te, p, x, gy, z, ct):
    """K7's twin (gtable, gx) and K8's (ct_gy, gtable2, ct_x)."""
    f = te.n_features_per_level
    table = torch.from_numpy(p).reshape(-1, f).to(torch.bfloat16)
    ct_table = torch.from_numpy(ct).reshape(-1, f).to(torch.bfloat16)
    xt, gyt = torch.from_numpy(x), torch.from_numpy(gy)
    first = grid_kernel._grid_backward_ig_plain(te.plan, table, xt, gyt)
    second = grid_kernel._grid_backward_bwd_plain(te.plan, table, ct_table, xt, gyt,
                                                  torch.from_numpy(z))
    return [t.numpy() for t in first], [t.numpy() for t in second]


def check_ig(d, cfg, seed):
    je, te, split, p, x, gy = pair(d, cfg, seed, batch=256, lo=0.05, hi=0.95)
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(x.shape[0], d)).astype(np.float32)
    ct = rng.normal(size=je.n_params).astype(np.float32)
    drops, (jg, jx), (jcp, jcx, jcg) = jax_ig(split, p, x, gy, z, ct)
    assert drops == 0
    (pg, px), (pcg, pcp, pcx) = port_ig(te, p, x, gy, z, ct)
    readings = {"gtable": rel(pg, jg), "gx": rel(px, jx), "gtable2": rel(pcp, jcp),
                "ct_x": rel(pcx, jcx),
                "ct_gy": rel(torch.from_numpy(pcg).to(torch.bfloat16).float().numpy(), jcg)}
    bounds = {"gtable": BINNED_GRAD_REL, "gx": IG_REL, "gtable2": BINNED_GRAD_REL,
              "ct_x": IG_REL, "ct_gy": IG_REL}
    assert all(readings[k] < bounds[k] for k in bounds), readings


@pytest.mark.parametrize("d,cfg,seed", [
    (2, enc_cfg(n_levels=2, base_resolution=128), 31),
    (3, enc_cfg(n_levels=1, base_resolution=32, interpolation="Smoothstep"), 41),
], ids=["2-D Linear, dense prefix + binned", "3-D Smoothstep, binned"])
def test_first_and_second_order_match_grid_encode_split_ig(d, cfg, seed):
    check_ig(d, cfg, seed)
