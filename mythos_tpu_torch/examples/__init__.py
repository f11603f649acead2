"""The reference's examples on the port: each module has a ``main()``."""
