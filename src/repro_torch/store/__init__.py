"""Content-addressed artifact store (PyTorch port of ``repro.store``) —
see ``store.store`` for layout/atomicity and ``store.content`` for the
identity scheme, which gives the reference's keys."""
from .content import (
    DIGEST_BYTES,
    array_digest,
    config_token,
    content_key,
    tree_digest,
)
from .store import ArtifactStore, features_to_tree, tree_to_features

__all__ = [
    "ArtifactStore",
    "DIGEST_BYTES",
    "array_digest",
    "config_token",
    "content_key",
    "features_to_tree",
    "tree_digest",
    "tree_to_features",
]
