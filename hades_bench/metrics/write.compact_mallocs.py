"""write.compact_mallocs: the cudaMalloc segments the allocator made
inside the window's compactions (`mem.cuda_mallocs{span=compact}`), per
compaction (`compact.runs`)."""
from hbench.phases import per_compaction


def read(win):
    return per_compaction(win, "mem.cuda_mallocs{span=compact}")
