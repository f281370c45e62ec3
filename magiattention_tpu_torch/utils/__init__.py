"""Utilities of the port: sample packing (``packing.py``)."""

from .packing import bin_cu_seqlens, pack_corpus, pack_documents, packing_efficiency

__all__ = ["bin_cu_seqlens", "pack_corpus", "pack_documents", "packing_efficiency"]
