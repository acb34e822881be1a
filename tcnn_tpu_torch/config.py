"""Top-level config entry point (counterpart of ``tcnn_tpu/config.py``;
config.h:46-63): `create_from_config(n_input_dims, n_output_dims, config)`
consumes the canonical 4-block JSON {loss, optimizer, encoding, network}
and returns a TrainableModel bundling the loss, the optimizer, the composed
NetworkWithInputEncoding and a Trainer.

A config that also holds instant-ngp's "dir_encoding" and "rgb_network"
blocks (its configs/nerf/*.json) builds instant-ngp's `NerfNetwork`
instead, as instant-ngp reads them: "encoding" the position encoding,
"network" the density network, and the ray loss of its "loss" block.
"""

from __future__ import annotations

import dataclasses
import json as _json

from .models.nerf import N_DENSITY_OUTPUTS, N_POS_DIMS, N_RGB, NerfNetwork
from .models.network_with_input_encoding import NetworkWithInputEncoding
from .ops.volume import RayLoss
from .registry import (
    cfg_get,
    cfg_has,
    create_encoding,
    create_loss,
    create_network,
    create_optimizer,
    minimum_alignment,
)
from .trainer import Trainer


def create_network_with_input_encoding(
    n_input_dims: int, n_output_dims: int, encoding_config: dict, network_config: dict
) -> NetworkWithInputEncoding:
    """cpp_api.h:113 / network_with_input_encoding.h:46-57."""
    encoding = create_encoding(n_input_dims, encoding_config)

    def factory(enc):
        return create_network(enc.padded_output_width, n_output_dims, network_config)

    encoding.set_alignment(minimum_alignment(network_config))
    return NetworkWithInputEncoding(encoding, factory)


def create_nerf_network(n_input_dims: int, n_output_dims: int, config: dict) -> NerfNetwork:
    """nerf_network.h's constructor: the position encoding on the first 3
    dims, the density network on it with 16 outputs unless its block sets
    "n_output_dims", the direction encoding on the other dims, and the rgb
    network on the density network's outputs and the direction encoding,
    with 3 outputs. The model outputs 4: rgb and the density."""
    if n_input_dims <= N_POS_DIMS or n_output_dims != N_RGB + 1:
        raise ValueError(f"a NeRF takes 3 position dims and a direction, and outputs 4; "
                         f"got {n_input_dims} -> {n_output_dims}")
    density_cfg = cfg_get(config, "network", {}) or {}
    rgb_cfg = cfg_get(config, "rgb_network", {}) or {}
    pos = create_encoding(N_POS_DIMS, cfg_get(config, "encoding", {}) or {},
                          minimum_alignment(density_cfg))
    density = create_network(pos.padded_output_width,
                             int(cfg_get(density_cfg, "n_output_dims", N_DENSITY_OUTPUTS)), density_cfg)
    dirs = create_encoding(n_input_dims - N_POS_DIMS, cfg_get(config, "dir_encoding", {}) or {},
                           minimum_alignment(rgb_cfg))
    rgb = create_network(density.padded_output_width + dirs.padded_output_width, N_RGB, rgb_cfg)
    return NerfNetwork(pos, density, dirs, rgb)


@dataclasses.dataclass
class TrainableModel:
    loss: object
    optimizer: object
    network: NetworkWithInputEncoding | NerfNetwork
    trainer: Trainer


def create_from_config(
    n_input_dims: int, n_output_dims: int, config: dict, seed: int = 1337, device="cuda"
) -> TrainableModel:
    optimizer = create_optimizer(cfg_get(config, "optimizer", {}) or {})
    loss_cfg = cfg_get(config, "loss", {}) or {}
    if cfg_has(config, "rgb_network") or cfg_has(config, "dir_encoding"):
        loss = RayLoss(cfg_get(loss_cfg, "otype", "Huber"))
        network = create_nerf_network(n_input_dims, n_output_dims, config)
    else:
        loss = create_loss(loss_cfg)
        network = create_network_with_input_encoding(
            n_input_dims,
            n_output_dims,
            cfg_get(config, "encoding", {}) or {},
            cfg_get(config, "network", {}) or {},
        )
    trainer = Trainer(network, optimizer, loss, seed=seed, device=device)
    return TrainableModel(loss, optimizer, network, trainer)


def load_config(path: str) -> dict:
    """Comment-tolerant JSON loading (mlp_learning_an_image.cu:151)."""
    with open(path) as f:
        text = f.read()
    # strip // line comments outside strings (good enough for config files)
    lines = []
    for line in text.splitlines():
        in_str = False
        out = []
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"' and (i == 0 or line[i - 1] != "\\"):
                in_str = not in_str
            if not in_str and c == "/" and i + 1 < len(line) and line[i + 1] == "/":
                break
            out.append(c)
            i += 1
        lines.append("".join(out))
    return _json.loads("\n".join(lines))
