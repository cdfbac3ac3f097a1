"""verify: acc.verify_chain over the chain (the upstream's acc_cmp_f
cells: K ASDL verifier steps and one final decider), one request a
chain."""

from portbench.chaincell import ChainCell


class Entry(ChainCell):
    def program(self, accs):
        self.acc.verify_chain(self.d, self.qss, accs, self.pp)

    def reference(self, ref, ch):
        ref.verify_chain(ch.d, ch.qss, ch.accs, ch.raw)
