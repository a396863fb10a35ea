"""Share of the window's launches whose op-suffix decode replayed a CUDA
graph that an earlier launch captured (the program's
``LaunchRecord.decode_graph``: ``replay``, ``capture`` or ``eager``).  A
launch that captured its graph in the window counts as not replayed."""


def read(ctx):
    modes = [getattr(r, "decode_graph", None) for r in ctx.records]
    if not modes or any(m is None for m in modes):
        return None
    return 100.0 * sum(m == "replay" for m in modes) / len(modes)
