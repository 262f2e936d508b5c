"""Table metadata and storage handles."""

from snappydata_tpu_torch.catalog.catalog import Catalog, TableInfo  # noqa: F401
