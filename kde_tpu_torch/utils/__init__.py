from .debug import fence  # noqa: F401
