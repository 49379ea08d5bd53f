"""Shared jitted runners of the reference's serving engine (no tests of
its own): the test files that build many reference engines import
``shared_runners`` and hold it open for the module.

The reference's ``ServeEngine`` builds a ``ModelRunner`` (five
``jax.jit`` closures) for every engine, so each engine compiles its
steps anew.  A runner holds no state of its own, only the model, the
layer context and the sampling settings its closures read, so while
``shared_runners`` is open an engine built on the same model object with
an equal context and the same settings gets the runner an earlier engine
built, and reuses its compiled steps wherever the shapes repeat.  The
computation is the one each engine would have compiled; the reference's
code is not changed, only the name its engine module looks up."""

import contextlib

import repro.serve.engine as _engine


@contextlib.contextmanager
def shared_runners():
    """Within the ``with``, reference engines share their ``ModelRunner``
    where model, context, temperature and top-k agree (an unhashable
    context gets a runner of its own)."""
    made = _engine.ModelRunner
    cache: dict = {}

    def runner(model, ctx, *, temperature=0.0, top_k=0):
        try:
            key = (id(model), ctx, float(temperature), int(top_k))
            hash(key)
        except TypeError:
            return made(model, ctx, temperature=temperature, top_k=top_k)
        if key not in cache:
            # the model rides along so its id is not reused while cached
            cache[key] = (model, made(model, ctx, temperature=temperature,
                                      top_k=top_k))
        return cache[key][1]

    _engine.ModelRunner = runner
    try:
        yield
    finally:
        _engine.ModelRunner = made
        cache.clear()
