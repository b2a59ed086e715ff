"""One module per traffic kind (``"kind"`` in a traffic file): set-up, the
measured window and the comparison with the reference."""
