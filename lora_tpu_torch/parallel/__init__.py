"""Training across processes (parallel/mesh.py), the counterpart of
lora_tpu/parallel/."""
