"""Evidence tools of the port, counterparts of the repo's ``tools/``:
``ab_angle_groups`` (the reference recipe on the ref-scale synthetic
corpus, one angle-group arm), ``tb_trajectory`` (a validation trajectory
table from a run's event files, or from its printed epoch lines) and
``convergence`` (tests/test_convergence_e2e.py's recipe); and
``accuracy_on_card.sh``, which runs the accuracy path on a card."""
