"""Top-level config entry point (counterpart of ``tcnn_tpu/config.py``;
config.h:46-63): `create_from_config(n_input_dims, n_output_dims, config)`
consumes the canonical 4-block JSON {loss, optimizer, encoding, network}
and returns a TrainableModel bundling the loss, the optimizer, the composed
NetworkWithInputEncoding and a Trainer.
"""

from __future__ import annotations

import dataclasses
import json as _json

from .models.network_with_input_encoding import NetworkWithInputEncoding
from .registry import (
    cfg_get,
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


@dataclasses.dataclass
class TrainableModel:
    loss: object
    optimizer: object
    network: NetworkWithInputEncoding
    trainer: Trainer


def create_from_config(
    n_input_dims: int, n_output_dims: int, config: dict, seed: int = 1337, device="cuda"
) -> TrainableModel:
    loss = create_loss(cfg_get(config, "loss", {}) or {})
    optimizer = create_optimizer(cfg_get(config, "optimizer", {}) or {})
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
