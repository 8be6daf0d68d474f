"""The forward of a recomputed region replays its first run.

``torch.utils.checkpoint`` (non-reentrant) runs a region's forward again
in the backward to rebuild what it did not save.  Three things in the
port's forward are not pure functions of its inputs, and must not happen
twice:

* a batch norm moves its running statistics (and takes batch statistics
  that are all-reduced under data parallelism);
* a Hebbian ``HConv`` adds its delta to ``HConv.delta``;
* a dropout draws a mask from its generator.

A :class:`Tape` goes with each checkpointed call.  Its first run records,
in call order, the values those steps produced (:meth:`Tape.keep`); a
recomputation replays them in the same order (:meth:`Tape.next`), and
:func:`replaying` tells the stateful steps to record nothing.  Outside a
checkpointed region :func:`current` is None and every step runs as usual.

A checkpoint matches the tensors a recomputation saves for the backward
to those the first run saved, by their order, and a selective checkpoint
(``remat_policy("convs")``) matches its ops likewise; so the ops of these
steps, which run in only one of the two, go around both
(:func:`untracked`): a Hebbian delta's own convolutions are not kept as
saved conv outputs, and the contrastive rule's inner autograd saves
nothing into the region.
"""

import threading
from contextlib import ExitStack, contextmanager

from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import _disable_current_modes

_LOCAL = threading.local()


class Tape:
    """The values kept by the first run of one checkpointed call."""

    def __init__(self):
        self.values = []
        self.runs = 0
        self.pos = 0

    @property
    def replaying(self):
        return self.runs > 1

    @contextmanager
    def run(self):
        """One run of the region (the first, or a recomputation) in the
        calling thread: the autograd engine recomputes in its own."""
        self.runs += 1
        self.pos = 0
        prev = getattr(_LOCAL, "tape", None)
        _LOCAL.tape = self
        try:
            yield self
        finally:
            _LOCAL.tape = prev

    def keep(self, value):
        self.values.append(value)
        return value

    def next(self):
        if self.pos >= len(self.values):
            raise RuntimeError("a recomputed forward asked for more kept "
                               "values than its first run kept")
        value = self.values[self.pos]
        self.pos += 1
        return value


def current():
    """The tape of the checkpointed region running in this thread, or
    None."""
    return getattr(_LOCAL, "tape", None)


def replaying():
    """Whether this thread is recomputing a checkpointed region."""
    tape = current()
    return tape is not None and tape.replaying


def _same(t):
    return t


@contextmanager
def untracked():
    """A context in which ops run around the dispatch modes and the
    saved-tensor hooks of a checkpointed region (a no-op outside one)."""
    with ExitStack() as stack:
        if current() is not None:
            stack.enter_context(_disable_current_modes())
            stack.enter_context(saved_tensors_hooks(_same, _same))
        yield


def stash(make):
    """``make()``, kept by a region's first run and replayed by its
    recomputations (a dropout mask)."""
    tape = current()
    if tape is None:
        return make()
    if tape.replaying:
        return tape.next()
    with untracked():
        return tape.keep(make())


def pin(t):
    """``t`` in a first run; in a recomputation the value the first run
    kept, exactly (``t - t.detach()`` is 0), with ``t``'s gradient."""
    tape = current()
    if tape is None:
        return t
    if tape.replaying:
        with untracked():
            return t - t.detach() + tape.next()
    tape.keep(t.detach())
    return t
