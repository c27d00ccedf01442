"""EPARA control plane pieces the serving slice needs (copied verbatim)."""
