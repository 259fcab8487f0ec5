"""The 10 architecture configs (full and smoke), one module each, as
``repro.configs`` has them."""
