"""setup_chunks: the device set-up's passes over row chunks in the run
(``pflare_tpu_torch.sparse.dell.SETUP_CHUNKS``, by product: SpGEMM,
restriction plan, lAIR blocks; a product that fits its limit counts one
pass, and each SpGEMM pass reads one integer back), in all.  None where
the program keeps no such counter or it is empty."""

import sys


def read(record):
    dell = sys.modules.get("pflare_tpu_torch.sparse.dell")
    chunks = getattr(dell, "SETUP_CHUNKS", None)
    total = sum(chunks.values()) if chunks else 0
    return total or None
