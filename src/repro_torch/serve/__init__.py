"""Serving: KV splicing, packed prefill and decode steps, the engine."""
