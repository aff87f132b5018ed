"""The arithmetic of the traffic mixes (the mixes themselves are the
``*.json`` files beside it)."""
