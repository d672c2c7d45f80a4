"""Structural graph keys (:func:`graph_key`).  Recordings, the graph cache
and the replay executor arrive with record-and-replay."""

from .graph_key import GraphKey, graph_key

__all__ = ["GraphKey", "graph_key"]
