"""Model code of the port (every family of the reference): the counterpart of ``repro.models``."""
