"""Serving stack — port of ``repro.serve``: the slot engine and its step
scheduler over a slot-indexed KV cache."""
