"""Runtime supervision of the port: the straggler watchdog and the
trainer's checkpoint-restart ``Supervisor`` (``fault.py``), and the train
step (``train_loop.py``); meshes and re-meshing wait for ROADMAP A13."""
