"""Small argument-handling helpers (a copy of ``openwakeword_tpu.utils.args``)."""

import functools
import inspect
import logging


def re_arg(kwarg_map):
    """Decorator mapping deprecated keyword-argument names to current ones,
    with a deprecation warning (same contract as reference utils.py:677-688).

    Uses functools.wraps so introspection (inspect.signature) sees the real
    function -- the reference's version hides the signature, which silently
    breaks its own bulk_predict kwarg filtering (reference utils.py:507-508).
    """
    def decorator(func):
        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            new_kwargs = {}
            for k, v in kwargs.items():
                if k in kwarg_map:
                    logging.warning(f"DEPRECATION: keyword argument '{k}' is no longer valid and "
                                    f"will be removed in future releases. Use '{kwarg_map[k]}' instead.")
                new_kwargs[kwarg_map.get(k, k)] = v
            return func(*args, **new_kwargs)
        return wrapped
    return decorator


def accepted_kwargs(func):
    """Names of keyword arguments ``func`` accepts (decorator-transparent)."""
    return set(inspect.signature(func).parameters.keys())
