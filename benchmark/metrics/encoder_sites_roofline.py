"""The encoder's kernel sites' share of their roofline, in percent: the sum
over the forward's sites (Swin blocks and block pairs, the cross-view
blocks' attention halves and MLP tails, the CVA cores, the ViT layers) of
max(flops / peak, bytes / peak bandwidth), from the configuration and the
batch by ``work.py``, over the device time of every operation launched inside
the model's encoder (the ``bench.encoder`` range).  The encoder's other work
(patch embeddings, merges, the frequency branch) sits in the denominator, so
this is a lower estimate whatever kernels run the sites."""


def read(run):
    if run.kind != "serve" or run.trace is None or run.bound_s_per_call is None:
        return None
    s = run.trace.device_s_in("encoder")
    if s <= 0:
        return None
    return 100.0 * run.bound_s_per_call / (s / run.trace.calls)
