"""The plain reference against the port's CPU twins at a tiny size. The
test may import the port; the reference may not."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

import small  # noqa: F401
from portbench import inputs
from portbench.reference import field as ref

BENCH = pathlib.Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def model_of(c):
    import tcnn_tpu_torch as tt

    blocks = {k: c[k] for k in ("loss", "optimizer", "encoding", "network")}
    return tt.create_from_config(c["n_input_dims"], c["n_output_dims"], blocks, device="cpu")


@pytest.mark.parametrize("name", ["hash_image", "sdf_grid", "ngp_image", "oneblob_image"])
def test_forward_matches_the_ports_f32_route(name):
    """At compute dtype f32 on a CPU tensor the port takes its plain route
    (an f32 gather and the f32 matmul chain): the reference computes the
    same function."""
    c = config(name)
    model = model_of(c)
    f = ref.Field(c)
    w = ref.initial_params(f, 5, 1.0, "cpu")
    x = torch.rand(777, c["n_input_dims"], generator=torch.Generator().manual_seed(1))
    got = model.network.apply(w, x, compute_dtype=torch.float32)[:, : c["n_output_dims"]]
    want = f.forward(w, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_rows_match_the_ports_index_math():
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    c = config("hash_image")
    enc = model_of(c).network.encoding
    g = ref.HashGrid(2, c["encoding"])
    assert g.rows == enc.plan.total_rows and g.offsets == list(enc.plan.offsets)
    assert g.hashed == list(enc.plan.use_hash)
    x = torch.rand(300, 2, generator=torch.Generator().manual_seed(2))
    corners = list(grid_kernel._corners(enc.plan, x))
    for level in range(g.n_levels):
        pos = x * torch.tensor(g.scales[level], dtype=torch.float32) + 0.5
        cells = torch.floor(pos).to(torch.int64)
        for corner, k in enumerate(corners):
            bits = torch.tensor([(corner >> d) & 1 for d in range(2)])
            assert torch.equal(g._level_rows(level, cells + bits), k.rows[:, level])


def test_oneblob_matches_the_ports_encoding():
    """The reference's OneBlob against the port's, in f32 on the CPU, over
    [0, 1) and at its edges, where the kernel wraps around."""
    from tcnn_tpu_torch.ops.encodings.fixed import oneblob_encode

    x = torch.rand(1000, 2, generator=torch.Generator().manual_seed(12))
    x[:4] = torch.tensor([[0.0, 1.0], [1e-4, 0.9999], [0.5, 0.25], [1.0 / 128, 63.0 / 64]])
    enc = ref.OneBlob(2, {"n_bins": 64})
    got = enc.encode(torch.zeros(0), x, ref.Rounding("f32"))
    assert got.shape == (1000, 128)
    assert torch.allclose(got, oneblob_encode(x, 64), rtol=0, atol=2e-7)


def test_oneblob_is_the_wrapped_kernels_mass_in_each_bin():
    """Each bin holds the mass of the quartic kernel 15/16 (1 - u^2)^2 of
    radius 1/n around x, wrapped onto [0, 1), by quadrature: it sums to 1
    over the bins of a dimension, and bins more than a radius away hold
    none."""
    n = 16
    x = torch.tensor([[0.0, 0.3], [0.97, 0.51]], dtype=torch.float64)
    got = ref.OneBlob(2, {"n_bins": n}).encode(torch.zeros(0), x.float(), ref.Rounding("f32")).double()
    t = (torch.arange(200_000, dtype=torch.float64) + 0.5) / 200_000   # midpoints over [0, 1)
    for i in range(2):
        for dim in range(2):
            d = (t - x[i, dim] + 0.5) % 1.0 - 0.5   # wrapped distance
            u = d * n
            density = torch.where(u.abs() < 1, 15.0 / 16.0 * (1 - u * u) ** 2 * n, torch.zeros_like(u))
            mass = torch.stack([density[(t >= k / n) & (t < (k + 1) / n)].sum() for k in range(n)]) / t.numel()
            row = got[i, dim * n : (dim + 1) * n]
            assert torch.allclose(row, mass, atol=1e-5)
            assert abs(float(row.sum()) - 1.0) < 1e-5


def test_relative_l2_matches_the_ports_loss_and_gradient():
    from tcnn_tpu_torch.ops.losses import RelativeL2Loss

    p = torch.rand(64, 16, generator=torch.Generator().manual_seed(3)).requires_grad_(True)
    t = torch.rand(64, 3, generator=torch.Generator().manual_seed(4))
    port = RelativeL2Loss()(p, t).sum()
    (gp,) = torch.autograd.grad(port, p)
    q = p.detach().requires_grad_(True)
    mine = ref.relative_l2(q[:, :3], t)
    (gm,) = torch.autograd.grad(mine, q)
    assert torch.allclose(port, mine, rtol=1e-6)
    assert torch.allclose(gp, gm, rtol=1e-5, atol=1e-9)


def test_adam_matches_the_ports_three_steps():
    from tcnn_tpu_torch.registry import create_optimizer

    c = config("hash_image")
    f = ref.Field(c)
    port = create_optimizer(c["optimizer"])
    port.allocate(f.n_params, f.mlp.shapes)
    state = port.init_state("cpu")
    mine = ref.TcnnAdam(c["optimizer"], f.n_params, f.mlp.n_params, "cpu")
    w_port = ref.initial_params(f, 9, 1e-4, "cpu")
    w_mine = w_port.clone()
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        g = torch.randn(f.n_params, generator=gen) * (torch.rand(f.n_params, generator=gen) < 0.3)
        port.step(state, 128.0, w_port, g * 128.0)
        w_mine = mine.step(w_mine, g)
    assert torch.allclose(w_port, w_mine, rtol=1e-6, atol=1e-9)


def test_torch_adam_matches_torch_optim():
    p = torch.nn.Parameter(torch.rand(50, generator=torch.Generator().manual_seed(7)))
    opt = torch.optim.Adam([p], lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    mine = ref.TorchAdam(1e-2, (0.9, 0.99), 1e-15, 50, "cpu")
    w = p.detach().clone()
    gen = torch.Generator().manual_seed(8)
    for _ in range(3):
        g = torch.randn(50, generator=gen)
        p.grad = g.clone()
        opt.step()
        w = mine.step(w, g)
    assert torch.allclose(p.detach(), w, rtol=1e-6, atol=1e-8)


def test_sdf_loss_gradient_is_the_references_up_to_bf16_rounding():
    """The eikonal loss's parameter gradient through the port's bf16 twins
    lies within 2% (norm of the difference) of the reference rounded where
    the program rounds, and its worst leaf's norm within 1% of the f32
    reference's; the float8 control's lies further."""
    from portbench import compare
    from tcnn_tpu_torch.samples import learn_a_sdf

    c = config("sdf_grid")
    model = model_of(c)
    w = ref.initial_params(ref.Field(c), 11, 1e-4, "cpu")
    xs = inputs.point_ring(3, 4096, 1, 3, "cpu")[0]
    p = w.clone().requires_grad_(True)
    (g_port,) = torch.autograd.grad(learn_a_sdf.sdf_loss(model.network, p, xs), p)
    grads = {}
    for precision in ("f32", "bf16", "fp8"):
        f = ref.Field(c, precision)
        q = w.clone().requires_grad_(True)
        (grads[precision],) = torch.autograd.grad(
            ref.sdf_loss(f, q, xs, learn_a_sdf.N_EIKONAL, learn_a_sdf.EIKONAL_WEIGHT), q)
    leaves = ref.Field(c).leaves()
    assert float((g_port - grads["bf16"]).norm() / grads["bf16"].norm()) < 0.02
    gap, _ = compare.worst_leaf_gap(g_port, grads["f32"], leaves)
    control, _ = compare.worst_leaf_gap(grads["fp8"], grads["f32"], leaves)
    assert gap < 0.01 < control


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.field, portbench.counts.field; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tcnn_tpu', 'tcnn_tpu_torch')); print(bad)") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
