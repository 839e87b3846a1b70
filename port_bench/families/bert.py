"""The port's BERT-large: ``models/bert.py`` trained on the MLM loss
through the BERT twin's ``captured_step``."""

from __future__ import annotations

from typing import Dict

import torch

from hivedscheduler_tpu_torch.models import bert
from hivedscheduler_tpu_torch.workloads import train_bert

from .. import inputs
from . import common


def port_config(cfg: Dict) -> bert.BertConfig:
    return bert.BertConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], max_seq_len=cfg["max_position_embeddings"],
        dtype=inputs.DTYPES[cfg["torch_dtype"]], remat=cfg["remat"])


class Trainer(common.Trainer):
    def __init__(self, cfg: Dict, params: Dict):
        self.config = port_config(cfg)
        opt = train_bert.make_optimizer(params)
        common.check_adamw(opt, cfg)
        super().__init__(params, opt)

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return train_bert.captured_step(self.params, self.opt, batch["tokens"],
                                        batch["targets"], self.config)
