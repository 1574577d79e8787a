"""Device time of the calls into a layer, by CUDA events the harness records
around them in the traced run's untraced window: pairs of events per layer,
read once the window has synchronised."""

import torch


class LayerClock:
    def __init__(self):
        self.pairs = {}
        self.open = {}
        self.handles = []

    def start(self, layer):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.open[layer] = ev

    def stop(self, layer):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.setdefault(layer, []).append((self.open.pop(layer), ev))

    def ms(self, layer):
        """Total milliseconds between each start and its stop (after a sync)."""
        return sum(a.elapsed_time(b) for a, b in self.pairs.get(layer, ()))

    def hook_forward(self, module, layer='forward'):
        """Times every call of ``module`` by forward pre- and post-hooks, until
        :meth:`detach`."""
        self.handles += [module.register_forward_pre_hook(lambda *_: self.start(layer)),
                         module.register_forward_hook(lambda *_: self.stop(layer))]

    def detach(self):
        for h in self.handles:
            h.remove()
        self.handles = []
