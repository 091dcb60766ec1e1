"""``torch.cuda.max_memory_allocated`` over the untraced window, reset as
it opened, in GiB: the headroom left for a larger batch."""


def read(obs):
    if not obs["peak_window_bytes"]:
        return None
    return obs["peak_window_bytes"] / 2 ** 30
