"""decide: acc.decide_many over every accumulator of the chain (the
upstream's acc_cmp_s cells: a decider at every step), one request a
chain; its units are the claims decided."""

from portbench.chaincell import ChainCell


class Entry(ChainCell):
    def __init__(self, cell):
        super().__init__(cell)
        self.units = len(self.chain.accs)

    def program(self, accs):
        self.acc.decide_many(accs, self.pp)

    def reference(self, ref, ch):
        ref.decide_many(ch.accs, ch.raw)
