from vqvdb_tpu_torch.format.vqvdb import (  # noqa: F401
    GridMetadata,
    VqvdbReader,
    VqvdbWriter,
    FORMAT_VERSION,
    MAGIC,
)
from vqvdb_tpu_torch.format.verify import (  # noqa: F401
    verify_container,
    verify_roundtrip,
)
