"""The reference's EXAMPLE drivers and its TEST/pdtest sweep, over the
port: one module per driver of the JAX package's ``examples/`` (pddrive,
pddrive1-4, pzdrive, pzdrive1-4, pddrive_ABglobal, pddrive_dist,
pddrive_df64, pddrive_refactor, pddrive_grid) and ``pdtest``, each with
``main(argv=None)``, on the card unless ``--device cpu``."""
