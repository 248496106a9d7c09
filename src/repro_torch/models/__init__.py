"""Language models: Hymba's hybrid attention + SSM blocks (prefill and decode)."""
