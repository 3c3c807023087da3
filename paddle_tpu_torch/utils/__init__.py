"""Host-side utilities of the port: event streams, the flag registry,
tree keys and seeded generators, the native build scaffold
(`utils.native`), DLPack interop (`utils.interop`) and introspection
(`utils.debug`)."""

from paddle_tpu_torch.utils.flags import FLAGS, get_flags, set_flags
from paddle_tpu_torch.utils import log
from paddle_tpu_torch.utils.debug import (dump_hlo, memory_stats,
                                          module_tree, module_tree_dot,
                                          op_census)
from paddle_tpu_torch.utils.interop import (
    from_dlpack, from_torch, to_dlpack, to_torch, tree_from_torch)

__all__ = ["FLAGS", "dump_hlo", "from_dlpack", "from_torch", "get_flags",
           "log", "memory_stats", "module_tree", "module_tree_dot",
           "op_census", "set_flags", "to_dlpack", "to_torch",
           "tree_from_torch"]
