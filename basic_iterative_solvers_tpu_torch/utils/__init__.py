from .timers import Stopwatch, Timers  # noqa: F401
