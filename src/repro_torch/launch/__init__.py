"""Launchers of the port: the LM serving engine (``serve``), the trainer
(``train``, its steps in ``train_step``), the community-detection service
(``community_serve``) and the distributed ranks (``ranks``)."""
