"""Evidence tools of the port, counterparts of the repo's ``tools/``:
``ab_angle_groups`` (the reference recipe on the ref-scale synthetic
corpus, one angle-group arm), ``tb_trajectory`` (a validation trajectory
table from a run's event files, or from its printed epoch lines) and
``convergence`` (tests/test_convergence_e2e.py's recipe); ``spm_ref``
(configs/spm_synth_ref.yaml's corpus and config copy); and
``accuracy_on_card.sh``, which runs the accuracy path on a card."""
