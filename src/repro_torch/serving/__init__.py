"""Serving data plane: composer, paged KV arena, sampler, engine."""
