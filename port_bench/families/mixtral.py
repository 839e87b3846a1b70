"""The port's Mixtral: ``models/mixtral.py`` trained through the Mixtral
twin's ``captured_step``."""

from __future__ import annotations

from typing import Dict

import torch

from hivedscheduler_tpu_torch.models import mixtral
from hivedscheduler_tpu_torch.workloads import train_mixtral

from .. import inputs
from . import common

PORT_RMS_EPS = 1e-5  # transformer.rms_norm's
PORT_AUX_WEIGHT = 0.01  # mixtral.lm_loss's default, which captured_step takes


def port_config(cfg: Dict) -> mixtral.MixtralConfig:
    common.require("rms_norm_eps", cfg["rms_norm_eps"], PORT_RMS_EPS)
    common.require("router_aux_loss_coef", cfg["assumed"]["router_aux_loss_coef"], PORT_AUX_WEIGHT)
    common.require("tie_word_embeddings", cfg["tie_word_embeddings"], False)
    return mixtral.MixtralConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        n_experts=cfg["num_local_experts"], experts_per_token=cfg["num_experts_per_tok"],
        capacity_factor=cfg["router_capacity_factor"],
        max_seq_len=cfg["max_position_embeddings"], rope_theta=cfg["rope_theta"],
        dtype=inputs.DTYPES[cfg["torch_dtype"]], remat=cfg["remat"])


class Trainer(common.Trainer):
    def __init__(self, cfg: Dict, params: Dict):
        self.config = port_config(cfg)
        opt = train_mixtral.make_optimizer(params)  # the twin's optax.adamw(1e-4)
        common.check_adamw(opt, cfg)
        super().__init__(params, opt)

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return train_mixtral.captured_step(self.params, self.opt, batch["tokens"], self.config)
