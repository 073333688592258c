"""The language-model stack of the port: ``config``, ``params``,
``layers``, ``mamba`` and ``model`` (the JAX package's ``repro.models``)."""
