"""The recurrent policy the reference serves and trains."""
