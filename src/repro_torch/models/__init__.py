"""Model code of the port (dense family): the counterpart of ``repro.models``."""
