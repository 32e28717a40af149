"""A training cell small enough for the CPU: the configuration files'
structure at d 64, 2 blocks, one decoder each way, a 40-token
dictionary, an epoch of 60 short utterances from a pool of 24 files;
no launch counts are required (the CPU runs no kernel)."""

from __future__ import annotations

import copy

from perfbench import spec


def tiny_cell(config: str = "aishell_conformer",
              traffic: str = "aishell_train") -> spec.Cell:
    base = spec.load_cell({"aishell_train": "aishell_train_bf16",
                           "librispeech_train": "librispeech_train_bf16"}
                          [traffic])
    c = copy.deepcopy(base.config)
    c["model_conf"].update(d_model=64, attention_heads=4, linear_units=128,
                           encoder_num_blocks=2, decoder_num_blocks=1,
                           r_decoder_num_blocks=1)
    c["vocab_size"] = 40
    c["dataset_conf"]["max_frames_in_batch"] = 1200 if c.get("accum_grad", 1) == 1 \
        else 3200
    c["warmup_epoch"] = 1
    t = copy.deepcopy(base.traffic)
    t.update(pool_utterances=24, epoch_utterances=60, offset_max_s=0.25,
             loader_workers=2,
             duration_s={"mean": 2.0, "sigma": 0.3, "min": 1.0, "max": 4.0})
    limits = copy.deepcopy(base.limits)
    limits["at_least"] = {}
    return spec.Cell(name=base.name + "_tiny", chips=1,
                     config_name=base.config_name, config=c,
                     traffic_name=base.traffic_name, traffic=t, limits=limits,
                     end_to_end=base.end_to_end, per_layer=base.per_layer)
