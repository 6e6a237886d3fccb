"""Offline dataset preprocessing CLIs (SURVEY.md L0).

Ports of the reference's one-shot label generators:
- :mod:`sroie`  — ``pipeline/sroie_data_preprocessing.py``
- :mod:`ephoie` — ``pipeline/ephoie_data_preprocessing.py``
- :mod:`funsd`  — ``pipeline/funsd_data_preprocessing.py``
- :mod:`split`  — ``utils/data_train_val_spilt.py`` / ``data_de_spilt.py``

All emit per-image CSV label files with columns
``left,top,right,bot,text,data_class,pos_neg`` (readme.md:31).
"""
