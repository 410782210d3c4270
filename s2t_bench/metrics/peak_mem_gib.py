"""torch.cuda.max_memory_allocated() over the untraced window, reset at
its start, in GiB."""


def read(r):
    b = r.timed.peak_mem_bytes
    return b / 2 ** 30 if b else None
