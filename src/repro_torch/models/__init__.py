"""Model code of the port (every family of the reference): the counterpart
of ``repro.models``.  ``shard_ctx`` holds the activation-sharding context a
launcher installs (the reference's ``models/shard_ctx.py``);
``data_parallel`` and ``tensor_parallel`` the groups a training forward
runs in, which GSPMD makes implicit in the reference."""
