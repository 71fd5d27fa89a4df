"""Host synchronisations a batch inside ``InferenceEngine.dispatch``: the
CUDA runtime's stream and device synchronisations and synchronous copies
that the trace shows inside the benchmark's dispatch spans (the NMS and
component fixpoints' ``torch.equal``, ``.item()`` and the like), over the
traced batches."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("dispatch_spans"):
        return None
    return tr["dispatch_syncs"] / tr["dispatch_spans"]
