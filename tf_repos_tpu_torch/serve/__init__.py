"""Serving (counterpart of the JAX package's serve/): versioned export,
the bucketed scorer on the card, and the micro-batching HTTP/gRPC
server. ``grpc`` is imported only by serve/grpc_server.py."""

from tf_repos_tpu_torch.serve.export import export_servable, latest_version_dir, load_servable
from tf_repos_tpu_torch.serve.scorer import Scorer

__all__ = ["export_servable", "load_servable", "latest_version_dir", "Scorer"]
