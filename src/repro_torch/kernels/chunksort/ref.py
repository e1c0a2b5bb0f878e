"""Plain chunk sort: the bit-identity oracle of the CUDA kernel.

Delegates to ``core.segments.stable_sort_with_perm`` (``torch.sort`` with
``stable=True``): the kernel's contract is bit-identity against exactly that
function.
"""
from __future__ import annotations

from ...core.segments import stable_sort_with_perm


def sort_with_perm_ref(keys):
    return stable_sort_with_perm(keys)
