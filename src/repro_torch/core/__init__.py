"""HADES core on PyTorch: RNS ring, keys, encryption, comparison.

Every function here works on int64 coefficient tensors in RNS (residue
number system) form, on the device the operands live on.
"""
# Functions named like their submodule (encrypt.encrypt, compare.compare)
# are not re-exported: rebinding them here would shadow the submodules
# for `import repro_torch.core.encrypt` users.
from repro_torch.core.params import HadesParams, Profile, make_params  # noqa: F401
from repro_torch.core.keys import KeySet, keygen  # noqa: F401
from repro_torch.core.encrypt import (  # noqa: F401
    Ciphertext,
    encrypt_fae,
    decrypt,
    decrypt_raw,
)
from repro_torch.core.compare import (  # noqa: F401
    compare_many,
    compare_fae,
    range_query,
    encrypted_sort,
    encrypted_topk,
)
