"""serve_tok_per_s: tokens emitted by all lanes in the window, unfinished
requests' included, over the window's seconds (host clock)."""


def read(run):
    tokens = sum(it["tokens"] for it in run.items)
    return tokens / run.window_s if run.window_s > 0 else None
