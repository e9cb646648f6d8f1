"""Device ms a MiB of document: the union of the intervals of every
kernel, memset and copy the card ran in the window, over the window's
document bytes (the dictionaries' bytes are the client's, not counted)."""


def read(w):
    if not w.device_ops or not sum(w.request_bytes):
        return None
    return 1e3 * w.busy_s / (sum(w.request_bytes) / (1 << 20))
