"""The port's benchmark (lora_tpu_torch on one H100); see run.py."""
