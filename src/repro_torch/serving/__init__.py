"""Serving: the FISH-routed continuous-batching engine and its decode-slot
manager."""
