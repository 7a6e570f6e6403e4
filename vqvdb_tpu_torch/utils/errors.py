"""Typed error hierarchy.

The reference's error model is exceptions -> cerr / Houdini node errors
(SURVEY §5 "failure detection: absent"). Here every boundary raises a typed
error so callers (CLI, Houdini shim, services) can distinguish user
mistakes from data corruption from environment failures. All subclass
ValueError to stay drop-in for existing callers and tests.
"""

from __future__ import annotations


class VqvdbError(ValueError):
    """Base class for all vqvdb_tpu_torch errors."""


class FormatError(VqvdbError):
    """Malformed or truncated .vqvdb container."""


class VersionError(FormatError):
    """Unsupported container version."""


class ModelMismatchError(VqvdbError):
    """File/model disagreement (codebook size, latent shape, probe)."""


class ArtifactError(VqvdbError):
    """Broken .vqmodel artifact."""


class ConfigError(VqvdbError):
    """Invalid configuration or argument combination."""
