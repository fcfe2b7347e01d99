"""Tiny configurations and mixes of the port's TINY_* topology, for the
benchmark's CPU tests (the cells' own files hold the published sizes)."""

import copy

from benchmark import inputs

TINY = {
    "name": "tiny",
    "port": {"unet": "TINY_UNET", "text_encoder": "TINY_TEXT",
             "vae": "TINY_VAE"},
    "dtype": "float32",
    "unet": {
        "attention_head_dim": 2, "block_out_channels": [32, 64, 64, 64],
        "cross_attention_dim": 32,
        "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                             "CrossAttnDownBlock2D", "DownBlock2D"],
        "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
        "layers_per_block": 2, "norm_eps": 1e-05, "norm_num_groups": 8,
        "out_channels": 4, "sample_size": 8,
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D",
                           "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"]},
    "text_encoder": {
        "hidden_act": "quick_gelu", "hidden_size": 32,
        "intermediate_size": 64, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 77, "num_attention_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 1000},
    "vae": {
        "block_out_channels": [16, 16, 32, 32], "in_channels": 3,
        "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 8,
        "out_channels": 3, "scaling_factor": 0.18215},
    "scheduler": {
        "beta_end": 0.012, "beta_schedule": "scaled_linear",
        "beta_start": 0.00085, "num_train_timesteps": 1000,
        "set_alpha_to_one": False, "steps_offset": 1,
        "prediction_type": "epsilon"},
}

TINY_SD2 = copy.deepcopy(TINY)
TINY_SD2["port"] = {"unet": "TINY_SD2_UNET", "text_encoder": "TINY_SD2_TEXT",
                    "vae": "TINY_VAE"}
TINY_SD2["unet"].update({"attention_head_dim": [2, 4, 4, 4],
                         "cross_attention_dim": 48,
                         "use_linear_projection": True})
TINY_SD2["text_encoder"].update({"hidden_act": "gelu", "hidden_size": 48,
                                 "intermediate_size": 96,
                                 "num_hidden_layers": 3,
                                 "num_attention_heads": 4})
TINY_SD2["scheduler"]["prediction_type"] = "v_prediction"


def tiny_mix(name: str, **over) -> dict:
    """A cell's mix at the tiny size: 64 px, 3 steps, short waits."""
    mix = inputs.load_json("traffic", name + ".json")
    small = {"height": 64, "width": 64, "steps": 3, "warmup_steps": 1,
             "wait_after_s": 30, "trace_after_s": 0.0, "trace_s": 0.5,
             "group_gap_s": 0.01}
    if mix["runner"] == "train_db":
        small = {"resolution": 64, "train_batch_size": 2,
                 "num_instance_images": 3,
                 "num_class_images": 5, "trace_after_steps": 1,
                 "trace_steps": 1}
    if mix["runner"] == "serve_closed":
        small.update(clients=4, max_batch=2, batch_buckets=[2])
    mix.update(small)
    mix.update(over)
    return mix


# every cell the benchmark has files for: (configuration, traffic mix);
# the tests drive them whether or not BENCHMARK.json lists them yet
CELLS = {"sd15.serve_closed": ("sd15", "closed_b8_512"),
         "sd15.train_db": ("sd15", "db_prior_b4_512"),
         "sd21.serve_closed": ("sd21", "closed_b4_768"),
         "sd15.serve_open": ("sd15", "open_poisson_512")}


def bench_with_all_cells(bench: dict) -> dict:
    """The manifest with an entry for every cell in CELLS."""
    have = {w["name"] for w in bench["workloads"]}
    extra = [{"name": c, "config": cfg, "traffic": mix, "chips": 1,
              "why": "test"} for c, (cfg, mix) in CELLS.items()
             if c not in have]
    return {**bench, "workloads": bench["workloads"] + extra}
