"""Input megabytes (10^6 B) compressed a second: every request's input
bytes over the whole window, from its start to the end of the last
request started inside `--seconds` (host clock). Where the traffic
gives a request a dictionary, its bytes are not counted: the client
already holds it."""


def read(w):
    return sum(w.request_bytes) / w.window_s / 1e6
