"""Console entry points of the port (lora_db: DreamBooth-LoRA training)."""
