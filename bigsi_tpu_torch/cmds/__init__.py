from bigsi_tpu_torch.cmds.bloom import bloom
from bigsi_tpu_torch.cmds.build import build, load_bloomfilter
from bigsi_tpu_torch.cmds.insert import insert
from bigsi_tpu_torch.cmds.merge import merge
from bigsi_tpu_torch.cmds.delete import delete
from bigsi_tpu_torch.cmds.variant_search import (
    BIGSIVariantSearch,
    BIGSIAminoAcidMutationSearch,
)

__all__ = [
    "bloom",
    "build",
    "load_bloomfilter",
    "insert",
    "merge",
    "delete",
    "BIGSIVariantSearch",
    "BIGSIAminoAcidMutationSearch",
]
